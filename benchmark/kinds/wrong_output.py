"""Kind `wrong_output`: statement s's proof, its claimed output moved by
`a`."""

from benchmark.reference.oracle import MODULUS


def draw(mix, rng, n):
    return ("wrong_output", rng.randrange(mix.statements),
            rng.randrange(1, MODULUS), 0)


def blob(mix, req):
    return mix.ring[req[1]][0]


def statement(mix, req):
    inp, out = mix.own_statement(req[1])
    return inp, (out + req[2]) % MODULUS
