"""Generation runners (port of the JAX package's ``generation/runner.py``).

Two backends behind the reference runner surface (no-arg constructible,
``.chat(messages, **knobs) -> str``, legacy ``.generate(prompt) -> str``):

- ``LlamaCppRunner``: thin shim over llama-cpp-python when installed and a
  GGUF file exists (n_ctx=4096, seed=42, LLAMA_GPU_LAYERS honored).
- ``ExtractiveRunner``: deterministic, dependency-free grounded answering —
  scores context-block sentences by lexical overlap with the question and
  composes a cited answer (a copy of the JAX package's, same answers).

The JAX package's third backend, its own decoder (``TPUDecodeRunner``),
is not ported yet (ROADMAP §1, decoder). ``get_runner`` follows the JAX
package's selection (explicit backend, else llama_cpp → decoder →
extractive) and raises ``NotImplementedError`` wherever that selection
would build the decoder, instead of answering extractively in its place.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from classmate_rag_tpu_torch.config import Config, load_config
from classmate_rag_tpu_torch.index.lexical import tokenize_py
from classmate_rag_tpu_torch.utils.lang import detect_lang_tag

logger = logging.getLogger(__name__)

# (model_path, repo_id, filename) triples whose GGUF resolution failed
# this process — skip re-attempting the (possibly slow) download per ask.
_FAILED_GGUF_RESOLVES: set = set()

Messages = Sequence[Dict[str, str]]

_DECODER_NOT_PORTED = (
    "the decoder runner is not ported yet (ROADMAP §1, decoder): {}"
)


def _last_user_content(messages: Messages) -> str:
    for m in reversed(list(messages)):
        if m.get("role") == "user":
            return str(m.get("content") or "")
    return ""


_CONTEXT_RE = re.compile(
    r"Context:\n(?P<ctx>.*?)\n\nQuestion:\n(?P<q>.*?)\n\nAnswer:",
    re.DOTALL,
)


class ExtractiveRunner:
    """Deterministic cited answering by sentence selection."""

    model_name = "extractive"

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    # -- core ----------------------------------------------------------
    @staticmethod
    def _split_blocks(ctx: str) -> List[tuple[int, str]]:
        """Split the numbered context into ([n], text) blocks by the
        '[n] ' anchors themselves — not on blank lines: chunk text can
        contain '\\n\\n', and a blank-line split would drop every
        continuation paragraph of a block."""
        blocks: List[tuple[int, str]] = []
        anchors = [
            m for m in re.finditer(r"(?m)^\[(\d+)\] ", ctx)
        ]
        for i, m in enumerate(anchors):
            end = anchors[i + 1].start() if i + 1 < len(anchors) else len(ctx)
            blocks.append((int(m.group(1)), ctx[m.end():end].strip()))
        return blocks

    @staticmethod
    def _sentences(text: str) -> List[str]:
        parts = re.split(r"(?<=[.!?])\s+", text)
        return [p.strip() for p in parts if p.strip()]

    def answer_grounded(self, question: str, ctx: str,
                        max_sentences: int = 3) -> str:
        lang = detect_lang_tag(question)
        q_terms = set(tokenize_py(question, lang))
        scored: List[tuple[float, int, int, str]] = []
        for block_no, text in self._split_blocks(ctx):
            for s_idx, sent in enumerate(self._sentences(text)):
                s_terms = set(tokenize_py(sent, lang))
                if not s_terms:
                    continue
                overlap = len(q_terms & s_terms)
                if overlap == 0:
                    continue
                score = overlap / (1.0 + 0.1 * len(s_terms))
                scored.append((score, block_no, s_idx, sent))
        if not scored:
            return "I don't know." if lang != "it" else "Non lo so."
        scored.sort(key=lambda t: (-t[0], t[1], t[2]))
        picked = scored[:max_sentences]
        # Present in block order for readability; cite each sentence.
        picked.sort(key=lambda t: (t[1], t[2]))
        seen_sent = set()
        parts = []
        for _score, block_no, _s, sent in picked:
            if sent in seen_sent:
                continue
            seen_sent.add(sent)
            parts.append(f"{sent} [{block_no}]")
        return " ".join(parts)

    # -- public surface -------------------------------------------------
    def chat(self, messages: Messages, **_: Any) -> str:
        user = _last_user_content(messages)
        m = _CONTEXT_RE.search(user)
        if m:
            return self.answer_grounded(m.group("q").strip(), m.group("ctx"))
        # General (context-free) prompt: deterministic honest fallback.
        lang = detect_lang_tag(user)
        return (
            "Non ho abbastanza informazioni per rispondere."
            if lang == "it"
            else "I don't have enough information to answer that."
        )

    def chat_batch(self, messages_list: Sequence[Messages],
                   **kwargs: Any) -> List[str]:
        """Host-side runner: batching is just a loop."""
        return [self.chat(m, **kwargs) for m in messages_list]

    def generate(self, prompt: str, **_: Any) -> str:
        return self.chat([{"role": "user", "content": prompt}])


class LlamaCppRunner:
    """llama-cpp-python shim with the reference's defaults and knobs."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        n_ctx: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> None:
        from llama_cpp import Llama  # raises ImportError when absent

        cfg = load_config()
        path = Path(model_path or cfg.llm_model_path).expanduser()
        if not path.exists():
            from classmate_rag_tpu_torch.model_fetch import (
                ensure_llama_model_available,
            )

            path = ensure_llama_model_available(
                path,
                repo_id=cfg.llm_repo_id or None,
                filename=cfg.llm_filename or None,
            )
        self.model_name = path.name
        self._llama = Llama(
            model_path=str(path),
            n_ctx=int(n_ctx or cfg.llm_n_ctx),
            seed=int(seed if seed is not None else cfg.llm_seed),
            n_gpu_layers=cfg.llama_gpu_layers,
            verbose=False,
        )

    def chat(
        self,
        messages: Messages,
        max_tokens: int = 768,
        temperature: float = 0.2,
        top_p: float = 0.95,
        **kwargs: Any,
    ) -> str:
        out = self._llama.create_chat_completion(
            messages=list(messages),
            max_tokens=max_tokens,
            temperature=temperature,
            top_p=top_p,
            **{k: v for k, v in kwargs.items() if k in ("repeat_penalty",)},
        )
        return out["choices"][0]["message"]["content"] or ""

    def generate(self, prompt: str, max_tokens: int = 768,
                 **kwargs: Any) -> str:
        out = self._llama(prompt, max_tokens=max_tokens, **kwargs)
        return out["choices"][0]["text"] or ""


def get_runner(cfg: Optional[Config] = None,
               model_path: Optional[str] = None):
    """Backend selection: explicit config, else llama_cpp → decoder →
    extractive, as in the JAX package; the decoder raises."""
    cfg = cfg or load_config()
    backend = cfg.llm_backend.lower()
    if backend == "extractive":
        return ExtractiveRunner()
    if backend in ("llama_cpp", "auto"):
        try:
            return LlamaCppRunner(model_path=model_path)
        except Exception as exc:
            # "auto" degrades to the decoder/extractive backends on any
            # construction failure; an explicit llama_cpp backend
            # surfaces the real error.
            if backend == "llama_cpp":
                raise
            logger.debug(
                "llama_cpp runner unavailable (%s: %s); falling through",
                type(exc).__name__, exc,
            )
    if backend == "tpu":
        raise NotImplementedError(_DECODER_NOT_PORTED.format(
            "LLM_BACKEND=tpu"))
    if backend == "auto":
        model_dir = os.getenv("TPU_DECODER_MODEL_DIR")
        if model_dir and Path(model_dir).exists():
            raise NotImplementedError(_DECODER_NOT_PORTED.format(
                f"TPU_DECODER_MODEL_DIR={model_dir} resolves"))
        # The configured GGUF, resolved as the JAX package resolves it:
        # there it would run on the decoder.
        resolve_key = (cfg.llm_model_path, cfg.llm_repo_id, cfg.llm_filename)
        if resolve_key not in _FAILED_GGUF_RESOLVES:
            try:
                from classmate_rag_tpu_torch.model_fetch import (
                    ensure_llama_model_available,
                )

                gguf = ensure_llama_model_available(
                    cfg.llm_model_path,
                    repo_id=cfg.llm_repo_id or None,
                    filename=cfg.llm_filename or None,
                )
            except Exception as exc:
                _FAILED_GGUF_RESOLVES.add(resolve_key)
                logger.debug("GGUF resolve failed (%s); falling through", exc)
            else:
                if gguf.suffix == ".gguf":
                    raise NotImplementedError(_DECODER_NOT_PORTED.format(
                        f"the GGUF {gguf} resolves"))
    return ExtractiveRunner()
