"""Whether the verdicts of the measured window are correct.

Every verdict delivered in the window is held against the frozen
reference's verdict for the same bytes and statement.  Requests that share
their content (every honest request of a statement, a truncated or empty
blob, the small family's proof, one statement's proof claimed as another's)
are judged once a content and every one of them is compared.  Requests of
unique content (a flipped bit, a moved output) are compared on a sample
drawn from the seed, `reference_sample` of them at most, because the
reference takes some 50 ms a proof.  The reference runs after the window,
in parallel processes that import no torch.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor

from . import mix as mixmod
from .reference import verdict as ref


def _judge(args) -> bool:
    return ref.verdict(*args)


def choose(requests: list, sample: int, seed: int) -> set:
    """The content keys to judge: every shared content, and a seeded sample
    of at most `sample` unique ones (in window order, then drawn)."""
    keys, unique = set(), []
    for r in requests:
        if mixmod.shares_content(r):
            keys.add(mixmod.content_key(r))
        else:
            unique.append(r)
    rng = random.Random(seed ^ 0x5EED)
    if len(unique) > sample:
        unique = rng.sample(unique, sample)
    keys.update(unique)
    return keys


def reference_verdicts(keys: set, mix, config: dict,
                       workers: int | None = None) -> dict:
    """{content key: the reference's verdict}."""
    log_steps, nc = int(config["log_steps"]), int(config["num_constants"])
    power = int(config.get("power", 3))
    fixed_out = None
    if config["statement"] == "fixed":
        # the fixed statement's verifier computes the output itself
        fixed_out = ref.mimc_output(int(config["input"]), log_steps, nc,
                                    power)
    order = sorted(keys, key=repr)
    jobs = []
    for k in order:                   # a key is a request of its content
        inp, out = mix.statement(k)
        jobs.append((mix.blob(k), inp,
                     fixed_out if fixed_out is not None else out,
                     log_steps, nc, power))
    n = max(1, min(len(jobs), workers or os.cpu_count() or 1))
    with ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn")) as ex:
        got = list(ex.map(_judge, jobs, chunksize=max(1, len(jobs) // n // 4)))
    return dict(zip(order, got))


def compare(delivered: list, truth: dict) -> tuple:
    """(compared, wrong): verdicts whose content was judged, and those of
    them that differ from the reference."""
    compared = wrong = 0
    for req, v in delivered:
        k = mixmod.content_key(req)
        if k in truth:
            compared += 1
            wrong += bool(v) != truth[k]
    return compared, wrong
