"""Plain references, one a model family: PyTorch ops only, no module of
the program, of JAX or of the JAX package."""
