"""The JAX package's two examples on the port (``examples/`` holds the JAX
ones). Run each with ``python -m tpu_huffman_torch.examples.<name>
[--device cuda|cpu]``."""
