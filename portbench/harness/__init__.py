"""The benchmark's own library: loading a cell from data, the seeded
inputs and weights, spans, the device trace, the work counts and peaks,
and the result line. Nothing here imports JAX or the JAX package."""
