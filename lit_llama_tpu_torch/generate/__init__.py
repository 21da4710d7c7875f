"""Generation entry points (counterparts of the root generate.py and of
generate/lora.py)."""
