"""Example training scripts of the port, run as modules:
``python -m torch_automatic_distributed_neural_network_tpu_torch.examples.train_gpt2``."""
