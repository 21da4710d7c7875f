"""Instruction prompts (counterpart of the prompt template of
lit_llama_tpu/data/sft.py; the SFT dataset pipeline comes with finetuning)."""

from __future__ import annotations


def generate_prompt(example: dict) -> str:
    """The alpaca instruction prompt, with an ``### Input:`` section when the
    example has a non-empty ``input``."""
    if example.get("input"):
        return (
            "Below is an instruction that describes a task, paired with an input that provides further context. "
            "Write a response that appropriately completes the request.\n\n"
            f"### Instruction:\n{example['instruction']}\n\n### Input:\n{example['input']}\n\n### Response:"
        )
    return (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{example['instruction']}\n\n### Response:"
    )
