"""The LM family's model code: layers, attention, MoE, the transformer,
and the conversion of the JAX package's parameter trees."""
