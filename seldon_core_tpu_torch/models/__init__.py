"""The llama decoder, its weights and the generative registry."""
