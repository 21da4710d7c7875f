"""Multi-process inference and training on ``torch.distributed``
(counterpart of lit_llama_tpu/parallel/): one process a rank, as
``torchrun`` starts them.

``launch`` joins the ranks into a world group, ``mesh`` lays them out as a
``("data", "model")`` device mesh, ``comm`` holds the collectives the model
calls (and their differentiable forms), ``tp`` lays the weights and the KV
cache out for tensor parallelism (the dense layout training shares) and runs
the TP forward and ``generate_tp``, and ``sharding`` shards a training tree
over the mesh (DP, FSDP, TP). Importing the package starts nothing.
"""
