"""The LM stack of the port: layers, the RWKV-6 block, the KV cache and
recurrent state, the decoder stack and the weight converter from the JAX
package's parameter tree."""
