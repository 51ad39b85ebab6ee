"""Several ranks (``torch.distributed``): the counterpart of
``pronerf_tpu/parallel/``. ``launch`` makes the process groups,
``data_parallel`` splits a training batch over ranks, ``render_parallel`` a
frame, and ``multi_scene`` lays several scenes over them."""
