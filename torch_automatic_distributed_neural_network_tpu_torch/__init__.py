"""tadnn on PyTorch and CUDA: the port of the JAX package
``torch_automatic_distributed_neural_network_tpu`` to an NVIDIA H100.

This slice holds the paged serving path: the GPT-2 and Llama decoder
families (``models``), KV-cached decoding (``inference.decode``), the
paged KV pool, scheduler and continuous-batching engine
(``inference.serve``), and the paged decode-attention kernel written in
CUDA C++ for Hopper (``ops.paged_attention``, source in ``csrc/``).
``python -m torch_automatic_distributed_neural_network_tpu_torch serve``
runs it.  It imports torch and numpy, never jax.

Entry points run on the card unless the caller passes ``device="cpu"``,
where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
