"""PyTorch/CUDA port of EM-POSE for NVIDIA Hopper (H100).

Serves the released LGD-RNN models on the card with a hand-written CUDA
kernel for the weight-resident LSTM stack. Imports torch and numpy only,
never jax or the ``empose_tpu`` reference package. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
