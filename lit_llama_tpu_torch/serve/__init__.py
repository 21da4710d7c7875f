from lit_llama_tpu_torch.serve.engine import DecodeEngine, Request

__all__ = ["DecodeEngine", "Request"]
