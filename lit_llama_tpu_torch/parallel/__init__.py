"""Multi-process inference on ``torch.distributed`` (counterpart of
lit_llama_tpu/parallel/): one process a rank, as ``torchrun`` starts them.

``launch`` joins the ranks into a world group, ``mesh`` lays them out as a
``("data", "model")`` device mesh, ``comm`` holds the collectives the model
calls, and ``tp`` lays the weights and the KV cache out for tensor
parallelism and runs the TP forward and ``generate_tp``. Importing the
package starts nothing.
"""
