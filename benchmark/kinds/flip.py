"""Kind `flip`: statement s's proof with bit `b` of byte `a` flipped, the
byte drawn inside one protocol site (`reference.wire_sites`).  Flips take
the mix's `flip_sites` in turn (all twelve where it names none)."""

from benchmark.reference import wire_sites


def prepare(mix):
    sites = tuple(mix.traffic.get("flip_sites", wire_sites.SITES))
    if set(sites) - set(wire_sites.SITES):
        raise ValueError(f"unknown sites in {sites}")
    mix.flip_sites = sites
    mix.site_sizes = [wire_sites.site_sizes(r) for r in mix.proofs.sites]


def draw(mix, rng, n):
    s = rng.randrange(mix.statements)
    site = mix.flip_sites[n % len(mix.flip_sites)]
    k = rng.randrange(mix.site_sizes[s][site])
    off = wire_sites.byte_at(mix.proofs.sites[s], site, k)
    return ("flip", s, off, rng.randrange(8))


def blob(mix, req):
    return wire_sites.flip(mix.proofs.blobs[req[1]], req[2], req[3])
