"""Kind `truncated`: the first third of statement s's proof."""


def draw(mix, rng, n):
    return ("truncated", rng.randrange(mix.statements), 0, 0)


def blob(mix, req):
    b = mix.proofs.blobs[req[1]]
    return b[:len(b) // 3]


def key(req):
    return req
