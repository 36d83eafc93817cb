"""Tools of the port: the synthetic scene generator, the overlay render,
the 3D tracking validation, the anipose session tools, the COCO-style
evaluation (``evaluation``, ``coco_eval``), the 2D-only video tool
(``run2d``), the tracker sweep (``sweep``), the pipeline benchmark
(``pipeline_bench``), the card's probes (``int8_probe``,
``roialign_probe``, ``trunk_probe``) and the renderer of the README and
PERF.md tables from a benchmark line measured on the card
(``perf_tables``).

Where a tool reads or writes files with cv2, pandas, h5py or matplotlib,
its array work is a function of its own that needs none of them, and that
is what runs on the card's machine: ``coco_eval.coco_eval_arrays`` and
``run2d.pose_2d_frames`` (the networks on the card; ``run_coco_eval`` and
``render_2d_video`` read images and videos with cv2),
``session.triangulate_arrays`` and ``filter_pose_2d_arrays``. The sweep
writes its recording without cv2 where cv2 is missing."""
