"""PyTorch EgoM2P model: transformer blocks, embeddings, the encoder-decoder."""
