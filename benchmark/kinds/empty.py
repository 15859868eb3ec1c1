"""Kind `empty`: no bytes, claimed as statement s."""


def draw(mix, rng, n):
    return ("empty", rng.randrange(mix.statements), 0, 0)


def blob(mix, req):
    return b""


def key(req):
    return ("empty", 0, 0, 0)
