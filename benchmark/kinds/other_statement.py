"""Kind `other_statement`: statement `a`'s proof, claimed as statement
s's."""


def prepare(mix):
    if mix.statements < 2:
        raise ValueError("other_statement needs two statements")


def draw(mix, rng, n):
    s = rng.randrange(mix.statements)
    o = rng.randrange(mix.statements - 1)
    return ("other_statement", s, o + (o >= s), 0)


def blob(mix, req):
    return mix.ring[req[2]][0]


def key(req):
    return req
