"""PyTorch/CUDA port of yolo_nano_tpu for NVIDIA Hopper (H100).

Batched inference (`serving.load_predictor`, `cli.common.make_predict_fn`
→ `models.yolo_nano.predict`) on a BN-folded model, with the JAX package's
two Pallas kernels rewritten as CUDA C++ (`csrc/`); the training step
(`train/`); VOC and COCO evaluation (`data/`, `evaluation/`, `cli/eval.py`).
It imports torch, numpy and cv2, never JAX or yolo_nano_tpu.
"""
