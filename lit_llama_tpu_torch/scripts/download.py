"""Download model weights from the HuggingFace hub (counterpart of the JAX
package's scripts/download.py: the same flags and hub call).

    python -m lit_llama_tpu_torch.scripts.download --repo_id openlm-research/open_llama_7b \
        --local_dir checkpoints/hf-llama/7B

Fetches the snapshot's ``*.bin``, ``*.json`` and ``*.model`` files through
``huggingface_hub.snapshot_download``, imported when the call runs (it is
not a dependency of the port). Without a network, point the entry points at
local checkpoints instead; ``scripts.make_tiny_checkpoint`` writes a
self-contained test model. Host work only: no ``--device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from lit_llama_tpu_torch.utils.cli import host_only

ALLOW_PATTERNS = ["*.bin", "*.json", "*.model"]


@host_only
def download_from_hub(repo_id: Optional[str] = None, local_dir: Path = Path("checkpoints/hf-llama/7B")) -> None:
    """Download a model snapshot from the HuggingFace hub.

    Args:
        repo_id: Hub repo, e.g. openlm-research/open_llama_7b.
        local_dir: Destination directory.
    """
    if repo_id is None:
        raise ValueError("Please pass --repo_id, e.g. openlm-research/open_llama_7b")
    from huggingface_hub import snapshot_download

    snapshot_download(repo_id, local_dir=local_dir, local_dir_use_symlinks=False, allow_patterns=ALLOW_PATTERNS)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(download_from_hub)
