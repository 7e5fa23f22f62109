"""The LM substrate's serving side (the port of ``repro.lm``): the ten
architectures' prefill and KV-cache decode over params trees with the JAX
package's keys."""
