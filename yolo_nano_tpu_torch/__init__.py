"""PyTorch/CUDA port of yolo_nano_tpu for NVIDIA Hopper (H100).

Batched inference (`serving.load_predictor` → `models.yolo_nano.predict`)
on a BN-folded model, with the JAX package's two Pallas kernels rewritten as
CUDA C++ (`csrc/`). It imports torch and numpy, never JAX or yolo_nano_tpu.
"""
