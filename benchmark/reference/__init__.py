"""The benchmark's plain reference: a frozen pure-Python verifier and prover
and its own walk of the wire format.  Nothing here imports torch, the port
or the JAX package."""
