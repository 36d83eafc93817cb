"""macaque_tpu_torch: the PyTorch/CUDA port of macaque_tpu.

The pipeline for one NVIDIA card, laid out like ``macaque_tpu``:
``pipeline/runner.py::run_pipeline`` chains stage 1 (detect -> track ->
pose -> ID, ``pipeline/step1.py``, with its serving tiers), step 2
(cross-view keyframe matching), step 3 (cross-frame tracklets), step 4
(Viterbi filter, triangulation, refinement) and the overlay render
(``tools/visualize.py``); ``demo.py`` and ``python -m macaque_tpu_torch``
drive it. ``nn/`` holds the models and the hand-written CUDA kernels'
wrappers (``nn/attention.py``, ``nn/roialign.py``, ``nn/int8.py``; sources
in ``csrc/``, built by ``kernels.py``); ``cameras/``, ``geometry/``,
``association/`` and ``filters/`` the geometry of steps 2-4;
``core/mesh.py`` shards the perception and steps 2-4 over several
devices in one process. It imports
torch, numpy and scipy; ``cv2``, ``yaml`` and ``h5py`` only inside the
functions that decode or encode video other than RGBA imgstore chunks,
draw the overlay, or read YAML configs and calibration files.
"""

__version__ = "0.1.0"
