"""The LM stack of the port: layers, KV cache, the decoder stack and the
weight converter from the JAX package's parameter tree."""
