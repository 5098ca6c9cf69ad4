"""PyTorch + CUDA port of tree_attention_tpu for NVIDIA Hopper GPUs."""
