"""macaque_tpu_torch: the PyTorch/CUDA port of macaque_tpu.

Stage 1 of the pipeline (detect -> track -> pose -> ID) and its serving
tiers, then step 2 (cross-view keyframe matching), for one NVIDIA card,
laid out like ``macaque_tpu``: ``nn/`` holds the models and the
hand-written CUDA kernels' wrappers (``nn/attention.py``,
``nn/roialign.py``, ``nn/int8.py``; sources in ``csrc/``, built by
``kernels.py``), ``pipeline/step1.py`` the per-camera loop,
``cameras/``, ``geometry/`` and ``association/`` the geometry of
``pipeline/step2.py``. It imports torch, numpy and scipy; ``cv2``,
``yaml`` and ``h5py`` only inside the functions that read or write video
stores, YAML configs and calibration files.
"""

__version__ = "0.1.0"
