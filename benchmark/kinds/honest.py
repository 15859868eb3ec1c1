"""Kind `honest`: statement s's own proof, `a` one of the ring's copies.

A kind of request is a module of this folder, named by the kind, that the
one generator (`mix.py`) finds by name.  It gives

- `draw(mix, rng, n)`: the n-th request of the kind, a tuple
  `(kind, statement, a, b)`, its choices drawn from `rng`;
- `blob(mix, req)`: the request's bytes;
- optionally `statement(mix, req)`: its (input, claimed output), where
  that is not statement s's own;
- optionally `key(req)`: a request with the same bytes and statement, where
  requests of the kind share their content, so that the reference judges
  each content once;
- optionally `prepare(mix)`: checks the mix can draw the kind.
"""


def draw(mix, rng, n):
    s = rng.randrange(mix.statements)
    return ("honest", s, (n + 1) % len(mix.ring[s]), 0)


def blob(mix, req):
    return mix.ring[req[1]][req[2]]


def key(req):
    return ("honest", req[1], 0, 0)
