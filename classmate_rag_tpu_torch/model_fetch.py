"""Ensure a local GGUF/HF model file exists, optionally auto-downloading.

Parity with the reference fetcher (rag/model_fetch.py:33-109): resolves the
path, and when the file is missing attempts a resumable
``huggingface_hub.snapshot_download`` restricted to the one file, reading
the token from HF_TOKEN / HUGGINGFACE_HUB_TOKEN / CLASSMATE_RAG_HF_TOKEN.
In offline environments (``HF_HUB_OFFLINE=1``) the download is skipped
with a clear error instead of a hang.

Host copy of the JAX package's ``model_fetch.py`` (no JAX).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def _hf_token() -> Optional[str]:
    for name in ("HF_TOKEN", "HUGGINGFACE_HUB_TOKEN", "CLASSMATE_RAG_HF_TOKEN"):
        tok = os.getenv(name)
        if tok:
            return tok
    return None


def ensure_llama_model_available(
    model_path: str | Path,
    *,
    repo_id: Optional[str] = None,
    filename: Optional[str] = None,
    models_dir: str | Path = "./models",
) -> Path:
    """Return a usable local model path, downloading if possible.

    Raises FileNotFoundError when the file is absent and no download route
    is available (no repo configured, hub not importable, or offline).
    """
    path = Path(model_path).expanduser()
    if path.exists():
        return path.resolve()

    if not repo_id:
        raise FileNotFoundError(
            f"Model file not found: {path}. Set LLM_REPO_ID/LLM_FILENAME to "
            "enable auto-download, or place the file manually."
        )
    want = filename or path.name
    try:
        from huggingface_hub import snapshot_download  # type: ignore
    except ImportError as exc:
        raise FileNotFoundError(
            f"Model file not found: {path} and huggingface_hub is not "
            "installed for auto-download."
        ) from exc
    if os.getenv("HF_HUB_OFFLINE") == "1":
        raise FileNotFoundError(
            f"Model file not found: {path} and HF_HUB_OFFLINE=1."
        )
    local_dir = Path(models_dir).expanduser()
    local_dir.mkdir(parents=True, exist_ok=True)
    snapshot_download(
        repo_id=repo_id,
        allow_patterns=[want],
        local_dir=str(local_dir),
        token=_hf_token(),
    )
    candidate = local_dir / want
    if not candidate.exists():
        matches = list(local_dir.rglob(want))
        if matches:
            return matches[0].resolve()
        raise FileNotFoundError(
            f"Download finished but {want} not found under {local_dir}."
        )
    return candidate.resolve()
