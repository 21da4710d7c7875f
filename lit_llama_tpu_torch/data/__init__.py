"""Data (counterpart of lit_llama_tpu/data/): the LITPKDS packed token
dataset, the SentencePiece tokenizer and the instruction prompt."""
