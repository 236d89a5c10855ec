"""The model zoo's code: layers, attention, MoE, the transformer, the
GNNs, MACE, BERT4Rec and EmbeddingBag, and the conversion of the JAX
package's parameter trees."""
