"""Generation entry points (counterparts of the root generate.py and of
generate/lora.py, generate/adapter.py and generate/adapter_v2.py)."""
