"""E5 encoder: batched, bucketed forward with E5 semantics (port of the
JAX package's ``embeddings/encoder.py``).

"query: "/"passage: " prefixes, L2-normalised float32 output. Inputs are
grouped into length buckets (32..512) and padded; the batch of each
bucket pads to the smallest of {8, 64, max_batch} that fits, with
``[[0]]`` rows, exactly as the JAX package dispatches, so both packages
run the same forward shapes. Weights live on the encoder's device.

``encode_queries_device`` returns the vectors as a tensor on that device
in input order (a gather on the device restores it), for the retriever
to hand to the fused hybrid step without a host fetch.

Data parallelism (``data_parallel`` != 1, the JAX package's
``_init_data_parallel``): a replica of the model on each of the first
``dp`` local devices; each padded batch splits into ``dp`` equal row
blocks, encoded on their devices and concatenated on the first. Per-row
math does not depend on the batch; a library GEMM may pick another
algorithm for a half batch, so the vectors equal the single-device
path's up to that rounding (bit for bit in the CPU tests).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device
from classmate_rag_tpu_torch.embeddings.model import (
    EncoderConfig,
    Params,
    encoder_flops,
    init_params,
    load_params_from_hf,
    params_from_numpy,
)
from classmate_rag_tpu_torch.embeddings.tokenizer import (
    bucket_length,
    load_tokenizer,
    pad_to_bucket,
)
from classmate_rag_tpu_torch.parallel.mesh import local_devices

# Target tokens per forward; batch = budget / bucket_len.
_TOKENS_PER_STEP = 16384


def data_parallel_degree(data_parallel: int, device: torch.device,
                         n_devices: Optional[int] = None) -> int:
    """The JAX package's clamp: 1 stays 1; 0 means every local device
    (``n_devices``, default ``device``'s local cards), n at most n; then
    the largest power of two <= min(devices, 8), so that it divides every
    padded batch (8, 64, 2^k)."""
    if data_parallel == 1:
        return 1
    avail = len(local_devices(device)) if n_devices is None else n_devices
    want = avail if data_parallel <= 0 else min(data_parallel, avail)
    return 1 << (min(want, 8).bit_length() - 1) if want > 1 else 1


class E5Encoder:
    """PyTorch E5 encoder with query/passage prefixes and length
    bucketing. Runs on CUDA unless ``device="cpu"``."""

    def __init__(
        self,
        model_name: str = "intfloat/multilingual-e5-base",
        model_dir: Optional[str] = None,
        config: Optional[EncoderConfig] = None,
        max_length: int = 512,
        params: Optional[Params] = None,
        data_parallel: int = 1,
        device: DeviceLike = None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ) -> None:
        """``devices``: where the data-parallel replicas go (default
        ``device``'s local cards; the first should be ``device``, where
        the outputs gather)."""
        self.device = resolve_device(device)
        devs = ([resolve_device(d) for d in devices] if devices is not None
                else local_devices(self.device))
        self._dp = data_parallel_degree(data_parallel, self.device,
                                        len(devs))
        self.model_name = model_name
        self.config = config or EncoderConfig.for_model_name(model_name)
        self.dim = self.config.hidden
        self.max_length = min(max_length, self.config.max_positions - 2)
        self.tokenizer = load_tokenizer(
            model_dir, max_length=self.max_length,
            vocab_size=self.config.vocab_size,
        )
        self.has_pretrained_weights = False
        if params is None and model_dir:
            params = load_params_from_hf(model_dir, self.config)
            self.has_pretrained_weights = params is not None
        if params is None:
            params = init_params(self.config, seed_key=model_name)
        self.model = params_from_numpy(params, self.config, self.device)
        # (device, model) of each data-parallel replica, one a device
        # (repeats too); the first is ``model`` when it sits on the
        # encoder's device.
        self._replicas = [
            (d, self.model if i == 0 and d == self.device
             else params_from_numpy(params, self.config, d))
            for i, d in enumerate(devs[: self._dp])
        ] if self._dp > 1 else []
        self.last_flops = 0.0

    # ------------------------------------------------------------------
    def _dispatch_bucket(self, ids: np.ndarray,
                         mask: np.ndarray) -> torch.Tensor:
        """One forward; returns [B, H] on the encoder's device (not
        fetched). With replicas, each takes one of ``dp`` equal row
        blocks on its own device."""
        self.last_flops += encoder_flops(self.config, ids.shape[0],
                                         ids.shape[1])
        with torch.no_grad():
            if not self._replicas or ids.shape[0] % self._dp:
                return self.model(torch.from_numpy(ids).to(self.device),
                                  torch.from_numpy(mask).to(self.device))
            outs = []
            for (dev, model), i, m in zip(
                    self._replicas, np.split(ids, self._dp),
                    np.split(mask, self._dp)):
                ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                       else contextlib.nullcontext())
                with ctx:
                    out = model(torch.from_numpy(i).to(dev),
                                torch.from_numpy(m).to(dev))
                outs.append(out.to(self.device, non_blocking=True))
            return torch.cat(outs)

    def _dispatch_groups(self, texts: Sequence[str], prefix: str):
        """Tokenize, bucket, and run one forward per padded batch.

        Yields ``(group_indices, device_vecs)``, device_vecs sliced to
        the group. The host and device encode paths share it, so they
        run the same forwards and differ only in how they consume them.
        """
        prefixed = [f"{prefix}{t or ''}" for t in texts]
        encoded = self.tokenizer.encode_batch(prefixed, self.max_length)

        by_bucket: dict[int, List[int]] = {}
        for i, ids in enumerate(encoded):
            by_bucket.setdefault(bucket_length(len(ids)), []).append(i)

        for bucket, indices in sorted(by_bucket.items()):
            max_batch = max(8, _TOKENS_PER_STEP // bucket)
            max_batch = 2 ** int(math.ceil(math.log2(max_batch)))
            for start in range(0, len(indices), max_batch):
                group = indices[start : start + max_batch]
                rows = [encoded[i] for i in group]
                # The batch pads to the smallest of {8, 64, max_batch}
                # that fits: a bounded set of shapes, as in the JAX
                # package, without a single query paying a 512-row
                # forward.
                for candidate in (8, 64, max_batch):
                    if len(rows) <= candidate:
                        batch_size = min(candidate, max_batch)
                        break
                n_pad = batch_size - len(rows)
                ids_arr, mask_arr = pad_to_bucket(rows + [[0]] * n_pad, bucket)
                yield group, self._dispatch_bucket(ids_arr, mask_arr)[: len(group)]

    def _encode_texts_device(self, texts: Sequence[str],
                             prefix: str) -> torch.Tensor:
        """[n, dim] f32 on the encoder's device, in input order."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        groups: List[List[int]] = []
        outs: List[torch.Tensor] = []
        for group, out in self._dispatch_groups(texts, prefix):
            groups.append(group)
            outs.append(out)
        if len(outs) == 1 and groups[0] == list(range(len(texts))):
            return outs[0]
        flat = np.concatenate([np.asarray(g, np.int64) for g in groups])
        inverse = np.empty(len(texts), np.int64)
        inverse[flat] = np.arange(len(texts))
        return torch.cat(outs).index_select(
            0, torch.from_numpy(inverse).to(self.device))

    def _encode_texts(self, texts: Sequence[str], prefix: str) -> np.ndarray:
        """The device path, fetched once at the end."""
        return self._encode_texts_device(texts, prefix).cpu().numpy()

    # Public surface (matches the reference embedder).
    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode_texts(texts, "query: ")

    def encode_passages(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode_texts(texts, "passage: ")

    def encode_queries_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Query vectors left on the device (see ``_encode_texts_device``)."""
        return self._encode_texts_device(texts, "query: ")
