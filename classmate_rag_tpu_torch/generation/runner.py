"""Generation runners (port of the JAX package's ``generation/runner.py``).

Three interchangeable backends behind the reference runner surface
(no-arg constructible, ``.chat(messages, **knobs) -> str``, legacy
``.generate(prompt) -> str``):

- ``LlamaCppRunner``: thin shim over llama-cpp-python when installed and a
  GGUF file exists (n_ctx=4096, seed=42, LLAMA_GPU_LAYERS honored).
- ``DecodeRunner``: the port's decoder (models/decoder.py) with KV-cache
  greedy/nucleus decode on the card — the JAX package's
  ``TPUDecodeRunner``. It loads a GGUF file or an HF checkpoint
  directory, or draws random weights from the model name.
- ``ExtractiveRunner``: deterministic, dependency-free grounded answering —
  scores context-block sentences by lexical overlap with the question and
  composes a cited answer (a copy of the JAX package's, same answers).

``get_runner`` follows the JAX package's selection: explicit backend,
else llama_cpp → decoder → extractive.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from classmate_rag_tpu_torch.config import Config, load_config
from classmate_rag_tpu_torch.device import DeviceLike, resolve_device
from classmate_rag_tpu_torch.index.lexical import tokenize
from classmate_rag_tpu_torch.utils.lang import detect_lang_tag

logger = logging.getLogger(__name__)

# (model_path, repo_id, filename) triples whose GGUF resolution failed
# this process — skip re-attempting the (possibly slow) download per ask.
_FAILED_GGUF_RESOLVES: set = set()

Messages = Sequence[Dict[str, str]]

# GGUF architectures of the MLA/MoE decoder (DeepSeek-V2), which the
# GGUF reader does not map.
_LATENT_GGUF_ARCHS = ("deepseek2",)

# What a GGUF that does not parse raises. ``auto`` falls through past
# such a file, as the JAX package does; a missing card or a CUDA error
# (RuntimeError) always propagates.
_GGUF_PARSE_ERRORS = (ValueError, KeyError, IndexError, struct.error,
                      OSError, EOFError)


def _flag(name: str) -> bool:
    return os.getenv(name, "").lower() in ("1", "true", "yes")


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
        q_terms = set(tokenize(question, lang))
        scored: List[tuple[float, int, int, str]] = []
        for block_no, text in self._split_blocks(ctx):
            for s_idx, sent in enumerate(self._sentences(text)):
                s_terms = set(tokenize(sent, lang))
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




class DecodeRunner:
    """The port's decoder (greedy/nucleus) behind a chat template, on
    one device (None → CUDA), or dp×tp over ``mesh`` (a ``DeviceMesh``;
    with ``TPU_DECODE_TP`` set and more than one card of the device's
    kind, ``auto_mesh_for`` over those cards).

    An MLA/MoE ``config`` (DeepSeek-V2) runs on one device in bf16: its
    weights come from ``hf_state`` (HF name → tensor, e.g. already on the
    card), an HF checkpoint directory, or a seeded draw on the device. It
    refuses int8 weights, a mesh or ``TPU_DECODE_TP`` over several cards,
    and a GGUF of architecture ``deepseek2``, with a ValueError."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        config=None,
        max_new_tokens: int = 256,
        max_seq: int = 1024,
        quantize: Optional[bool] = None,
        device: DeviceLike = None,
        mesh=None,
        hf_state=None,
    ) -> None:
        from classmate_rag_tpu_torch.embeddings.tokenizer import load_tokenizer
        from classmate_rag_tpu_torch.models.decoder import (
            DecoderConfig,
            init_params,
            load_params_from_hf,
            make_generate_fn,
        )
        from classmate_rag_tpu_torch.models.hf_state import (
            SeededHFState,
            params_from_hf_state,
        )

        self.device = (mesh[0][0] if mesh is not None
                       else resolve_device(device))
        if quantize is None:
            quantize = _flag("TPU_DECODE_INT8")

        # Config comes from the checkpoint when one is given. eos ids are
        # read whatever the config: checkpoints may declare several (e.g.
        # Llama-3-Instruct's [end_of_text, eot_id]) — the LAST one ends
        # chat turns, and all of them are stripped from output.
        self.eos_ids = [2]
        gguf_path: Optional[Path] = None
        gguf_metadata = None
        params = None
        if model_dir and str(model_dir).endswith(".gguf") and Path(
            model_dir
        ).is_file():
            # The reference's model files are GGUFs: params, config, eos
            # ids and the embedded tokenizer all come from the one file.
            from classmate_rag_tpu_torch.models.gguf import (
                load_params_from_gguf, read_gguf_header,
            )

            gguf_path = Path(model_dir)
            gguf_metadata = read_gguf_header(gguf_path)[0]
            arch = gguf_metadata.get("general.architecture")
            if arch in _LATENT_GGUF_ARCHS:
                raise ValueError(
                    f"GGUF {gguf_path.name}: architecture {arch!r} (MLA, "
                    "sparse experts) does not load from GGUF in the port; "
                    "give its HF checkpoint directory instead")
            config, params = load_params_from_gguf(
                gguf_path, config, host=True
            )
            eos_ids: List[int] = []
            eos = gguf_metadata.get("tokenizer.ggml.eos_token_id")
            if eos is not None:
                eos_ids.append(int(eos))
            # Sequence-end ids llama.cpp recognizes beyond the declared
            # eos (llama_token_is_eog): GGUF conversions routinely record
            # only <|end_of_text|> while chat turns end with <|eot_id|>.
            # The document-level end goes first; chat-turn enders go
            # LAST — self.eos_id (the last entry) is the id the decode
            # loop stops on.
            toks = gguf_metadata.get("tokenizer.ggml.tokens") or []
            tok_pos = {t: i for i, t in enumerate(toks)}
            doc_end = tok_pos.get("<|end_of_text|>")
            if doc_end is not None and doc_end not in eos_ids:
                eos_ids.insert(0, doc_end)
            for name in ("<|eot_id|>", "<|im_end|>"):
                tid = tok_pos.get(name)
                if tid is not None:
                    if tid in eos_ids:
                        eos_ids.remove(tid)
                    eos_ids.append(tid)
            if eos_ids:
                self.eos_ids = eos_ids
            model_dir = None
        if model_dir:
            if config is None:
                config = DecoderConfig.from_hf_config(model_dir)
            try:
                raw = json.loads(
                    (Path(model_dir) / "config.json").read_text()
                )
                eos = raw.get("eos_token_id")
                if isinstance(eos, int):
                    self.eos_ids = [eos]
                elif isinstance(eos, list):
                    ints = [e for e in eos if isinstance(e, int)]
                    if ints:  # keep the [2] default for non-int lists
                        self.eos_ids = ints
            except (OSError, ValueError):
                pass
        self.eos_id = self.eos_ids[-1]
        self.config = config or DecoderConfig.small()
        self.model_name = (
            gguf_path.name if gguf_path else f"tpu-decoder-{self.config.hidden}"
        )
        if self.config.latent:
            self._refuse_for_latent(quantize, mesh)
            if hf_state is not None:
                params = params_from_hf_state(hf_state, self.config,
                                              self.device)
            elif model_dir:
                params = load_params_from_hf(model_dir, self.config,
                                             self.device)
        elif hf_state is not None:
            raise ValueError("hf_state is taken for an MLA/MoE config only")
        elif model_dir:
            params = load_params_from_hf(model_dir, self.config)
        self.has_pretrained_weights = params is not None
        if params is None and self.config.latent:
            params = params_from_hf_state(
                SeededHFState(self.config, self.model_name, self.device),
                self.config, self.device)
        elif params is None:
            params = init_params(self.config, self.model_name)
        self._mesh = mesh
        if self.config.latent:
            # Placed on the device by the converter: no host tree.
            self.params, self._data_axis, self.quantized = params, 1, False
        else:
            self._place_dense(params, quantize)
        del params
        if gguf_metadata is not None and gguf_metadata.get(
            "tokenizer.ggml.tokens"
        ):
            from classmate_rag_tpu_torch.models.gguf import GGUFTokenizer

            self.tokenizer = GGUFTokenizer(gguf_metadata, max_length=max_seq)
        else:
            self.tokenizer = load_tokenizer(
                model_dir, max_length=max_seq,
                vocab_size=self.config.vocab_size,
            )
        # The KV cache and RoPE run to max_seq; don't exceed what the
        # checkpoint was trained for.
        max_seq = min(max_seq, self.config.max_seq)
        max_new_tokens = min(max_new_tokens, max(max_seq - 64, 16))
        self.max_new = max_new_tokens
        self.max_seq = max_seq
        if self._mesh is not None:
            from classmate_rag_tpu_torch.parallel.tp_decode import (
                make_tp_generate_fn,
            )

            self._generate = make_tp_generate_fn(
                self.config, self._mesh, max_seq, max_new_tokens)
        else:
            self._generate = make_generate_fn(self.config, max_seq,
                                              max_new_tokens)

    def _place_dense(self, params, quantize: bool) -> None:
        """A GQA tree (numpy) on the device, int8-quantized, or split over
        the mesh (``TPU_DECODE_TP`` over several cards)."""
        from classmate_rag_tpu_torch.models.decoder import (
            params_from_numpy,
            quantize_decoder_params_host,
        )

        if self._mesh is None and _flag("TPU_DECODE_TP"):
            from classmate_rag_tpu_torch.parallel.mesh import local_devices

            cards = local_devices(self.device)
            if len(cards) > 1:
                # The tp degree must divide THIS model's kv_heads and
                # ffn: auto_mesh_for picks the largest one that does.
                from classmate_rag_tpu_torch.parallel.tp_decode import (
                    auto_mesh_for,
                )

                self._mesh = auto_mesh_for(self.config, cards)
                self.device = self._mesh[0][0]
        # Every tree is numpy here: int8 quantizes on the host, so only
        # int8 + scales cross to the card (bit-equal to the JAX package's
        # on-device quantization).
        self.quantized = bool(quantize) and self._mesh is None
        if self._mesh is not None:
            # dp×tp decode: an 8B route model at bf16 exceeds one card's
            # memory; split it (parallel/tp_decode.py) instead.
            if quantize:
                logger.warning(
                    "TPU_DECODE_INT8 requested but a device mesh is "
                    "active: int8 quantization only applies to the "
                    "single-device path; decoding with bf16 sharded "
                    "weights.")
            from classmate_rag_tpu_torch.parallel.tp_decode import (
                shard_decoder_params,
            )

            self.params = shard_decoder_params(params, self.config,
                                               self._mesh)
            self._data_axis = self._mesh.shape["data"]
        else:
            if self.quantized:
                params = quantize_decoder_params_host(params, self.config)
            self.params = params_from_numpy(params, self.config,
                                            self.device)
            self._data_axis = 1

    def _refuse_for_latent(self, quantize: bool, mesh) -> None:
        what = None
        if quantize:
            what = "int8 W8A8 weights (TPU_DECODE_INT8)"
        elif mesh is not None:
            what = "a dp×tp device mesh"
        elif _flag("TPU_DECODE_TP"):
            from classmate_rag_tpu_torch.parallel.mesh import local_devices

            if len(local_devices(self.device)) > 1:
                what = "tensor-parallel decode over several cards " \
                       "(TPU_DECODE_TP)"
        if what:
            raise ValueError(
                f"an MLA/MoE decoder (DeepSeek-V2) runs in bf16 on one "
                f"device; the port does not run it with {what}")

    def _format_chat(self, messages: Messages) -> str:
        parts = []
        for m in messages:
            parts.append(f"<|{m.get('role','user')}|>\n{m.get('content','')}")
        parts.append("<|assistant|>\n")
        return "\n".join(parts)

    def generate_ids_batch(self, prompt_ids_list: Sequence[List[int]],
                           seed: int = 42, temperature: float = 0.0,
                           top_p: float = 0.95,
                           max_tokens: Optional[int] = None,
                           on_logits=None) -> List[List[int]]:
        """ONE batched decode for several prompts (left-padded to the
        shared width; the batch pads to a power of two, as the JAX
        package's does for its compile cache). Returns eos-stripped ids
        per prompt, truncated at the FIRST eos (any declared id stops the
        row) and clamped to ``max_tokens`` when given (the decode still
        runs the static max_new horizon). ``on_logits(step, logits)``
        sees each step's [B, V] logits before sampling (one device)."""
        b = len(prompt_ids_list)
        if b == 0:
            return []
        b_pad = 1 << (b - 1).bit_length() if b > 1 else 1
        # A dp-split batch must divide over the mesh's data axis.
        if b_pad % self._data_axis:
            b_pad = self._data_axis * (-(-b_pad // self._data_axis))
        width = self.max_seq - self.max_new
        arr = np.zeros((b_pad, width), dtype=np.int64)
        lens = np.zeros(b_pad, dtype=np.int64)
        for i, prompt_ids in enumerate(prompt_ids_list):
            ids = prompt_ids[-width:]
            arr[i, width - len(ids):] = ids
            lens[i] = len(ids)
        extra = {} if on_logits is None else {"on_logits": on_logits}
        with torch.inference_mode():
            toks = self._generate(
                self.params, arr, lens, seed, temperature, top_p,
                self.eos_ids, **extra,
            )
        out = toks.cpu().numpy()
        cap = self.max_new if max_tokens is None else max(
            min(int(max_tokens), self.max_new), 1
        )
        eos = set(self.eos_ids)
        results: List[List[int]] = []
        for i in range(b):
            row: List[int] = []
            for t in out[i].tolist()[:cap]:
                if t in eos:
                    break
                row.append(t)
            results.append(row)
        return results

    def generate_ids(self, prompt_ids: List[int], seed: int = 42,
                     temperature: float = 0.0, top_p: float = 0.95):
        return self.generate_ids_batch(
            [prompt_ids], seed=seed, temperature=temperature, top_p=top_p
        )[0]

    def _encode_prompt(self, messages: Messages) -> List[int]:
        prompt = self._format_chat(messages)
        width = self.max_seq - self.max_new
        # Decoder checkpoints bring their own tokenizer template; never
        # apply the XLM-R <s>…</s> framing to them.
        if hasattr(self.tokenizer, "encode_raw"):
            return self.tokenizer.encode_raw(prompt, max_length=width)
        return self.tokenizer.encode(prompt, max_length=width)

    def chat(
        self,
        messages: Messages,
        max_tokens: int = 768,
        temperature: float = 0.2,
        top_p: float = 0.95,
        **_: Any,
    ) -> str:
        ids = self._encode_prompt(messages)
        out_ids = self.generate_ids_batch(
            [ids], temperature=temperature, top_p=top_p,
            max_tokens=max_tokens,
        )[0]
        return self.tokenizer.decode(out_ids).strip()

    def chat_batch(
        self,
        messages_list: Sequence[Messages],
        max_tokens: int = 768,
        temperature: float = 0.2,
        top_p: float = 0.95,
        **_: Any,
    ) -> List[str]:
        """ONE batched decode for a micro-batch of conversations: the
        batch shares prefill and decode steps on the card."""
        prompt_ids = [self._encode_prompt(m) for m in messages_list]
        outs = self.generate_ids_batch(
            prompt_ids, temperature=temperature, top_p=top_p,
            max_tokens=max_tokens,
        )
        return [self.tokenizer.decode(ids).strip() for ids in outs]

    def generate(self, prompt: str, **kwargs: Any) -> str:
        return self.chat([{"role": "user", "content": prompt}], **kwargs)


def get_runner(cfg: Optional[Config] = None,
               model_path: Optional[str] = None,
               device: DeviceLike = None):
    """Backend selection: explicit config, else llama_cpp → decoder →
    extractive, as in the JAX package. The decoder runs on ``device``
    (None → CUDA)."""
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
    if backend in ("tpu", "auto"):
        # The reference's context window: llama.cpp ran with n_ctx=4096
        # and max_tokens=768; TPU_DECODE_MAX_SEQ bounds the KV cache.
        kw = dict(
            max_seq=int(os.getenv("TPU_DECODE_MAX_SEQ") or cfg.llm_n_ctx),
            max_new_tokens=cfg.llm_max_tokens,
            device=device,
        )
        model_dir = os.getenv("TPU_DECODER_MODEL_DIR")
        if model_dir and Path(model_dir).exists():
            return DecodeRunner(model_dir=model_dir, **kw)
        # The reference's configured model is a GGUF file
        # (LLM_MODEL_PATH/LLM_REPO_ID/LLM_FILENAME): resolve it the same
        # way and run it on the decoder.
        resolve_key = (cfg.llm_model_path, cfg.llm_repo_id, cfg.llm_filename)
        if resolve_key not in _FAILED_GGUF_RESOLVES:
            gguf = None
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
                # A missing file, or a hub download's network/HTTP error
                # (this host may have no egress): degrade, and memo the
                # failure so later asks do not pay a slow timeout again.
                _FAILED_GGUF_RESOLVES.add(resolve_key)
                logger.debug("GGUF resolve failed (%s); falling through", exc)
            if gguf is not None and gguf.suffix == ".gguf":
                try:
                    return DecodeRunner(model_dir=str(gguf), **kw)
                except _GGUF_PARSE_ERRORS as exc:
                    _FAILED_GGUF_RESOLVES.add(resolve_key)
                    logger.debug("GGUF %s does not load (%s: %s); falling "
                                 "through", gguf, type(exc).__name__, exc)
        if backend == "tpu":
            return DecodeRunner(**kw)
    return ExtractiveRunner()
