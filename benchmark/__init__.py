"""The port's benchmark: `python3 -m benchmark.run --workload <cell> ...`.

Everything here imports torch, numpy and `stark_verifier_tpu_torch` at
most; never JAX or the JAX package.  See `harness.py` for how a cell's
files are found by name.
"""
