"""Kind `small_family`: an honest proof of the first statement's input at
fewer steps (the traffic's `small_family_log_steps`), claimed as the first
statement."""


def prepare(mix):
    if not mix.proofs.small:
        raise ValueError("small_family needs small_family_log_steps")


def draw(mix, rng, n):
    return ("small_family", 0, 0, 0)


def blob(mix, req):
    return bytes(memoryview(mix.proofs.small))


def key(req):
    return req
