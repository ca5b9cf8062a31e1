"""Multi-GPU training over ``torch.distributed`` (counterpart of
``lipreading_tpu/parallel/``): the data x model mesh and its layouts
(``mesh.py``), the collectives written out (``comm.py``), ring attention
over the time axis (``ring.py``) and the GPipe encoder (``pipeline.py``).
The model axis carries one of tensor, sequence or pipeline parallelism.
"""
