"""LM token serving: continuous batching over a paged KV cache
(``bigdl_tpu/serving/lm.py``).

One request is a prompt prefill followed by a chain of single-token decode
steps.  The engine serves them the Orca/vLLM way:

- **Iteration-level (continuous) batching.**  The scheduler thread owns
  ``maxBatch`` decode slots.  Each iteration runs ONE decode step over all
  occupied slots; a sequence that finishes (EOS, token budget, deadline)
  vacates its slot and frees its KV blocks in that iteration, and a waiting
  prompt prefills into the vacancy.
- **Paged KV cache** (:class:`~bigdl_tpu_torch.serving.kv_cache.
  PagedKVCache`): one fixed device pool sized at construction, a host
  free-list and a block table per sequence.  Exhaustion is a retriable
  ``Overloaded`` at admission, never a device out-of-memory error.
- **One decode shape, one CUDA graph.**  The decode step always runs at
  ``(maxBatch, 1)``, inactive slots masked and scattering into the dump
  block.  On a CUDA device it is captured once as a CUDA graph (at
  :meth:`LMServingEngine.warmup`, or at the first decode) over static
  device buffers for the step's inputs and over the live pools; each
  iteration copies the host inputs into those buffers, replays the graph
  and pulls the ``(maxBatch, vocab)`` log-probs.  This is the port's twin
  of the JAX package's one compiled decode program and its zero-retrace
  contract: :attr:`LMServingEngine.decode_captures` stays 1 for the
  engine's life.  A capture or replay failure raises; a CUDA device has no
  eager decode path.  The decode step runs eagerly only on the CPU, where
  the caller asked for ``device="cpu"``.  Prefill and the teacher-forced
  full forward run eagerly over a bucket ladder of padded lengths.
- **Streaming output.**  :meth:`LMServingEngine.submit` returns a
  :class:`TokenStream` whose iterator yields tokens as the scheduler emits
  them.

The steps are built from the model's weights (:func:`_extract_params`) and
never call its ``forward``: prefill and the full forward use dense
:func:`~bigdl_tpu_torch.nn.attention.scaled_dot_product_attention` and
decode :func:`~bigdl_tpu_torch.nn.attention.paged_attention`, as the JAX
package's do, so this path launches no flash kernel.  Greedy tokens are
chosen on the host with ``np.argmax`` over the pulled log-probs, as the JAX
package chooses them.

Admission control, deadline shedding, poison quarantine, graceful drain and
the accounting identity ``completed + shed + rejected + quarantined ==
submitted`` follow :mod:`bigdl_tpu_torch.serving.engine`; a stream that
fails after streaming some tokens keeps them and ends with the structured
error that says why.

Not in this slice (each raises :class:`NotImplementedError` where a caller
asks for it; ROADMAP lists them): the int8 decode tier
(``quantize="int8"``, ``bigdl.lm.quantize=int8``) and its gate; the
hung-decode watchdog and its cooldown (``bigdl.lm.stallFactor > 0``); the
``sentinels`` property, for which :attr:`LMServingEngine.decode_captures`
stands in.  Also not ported: the chaos hooks, telemetry histograms, request
tracing, incident bundles, the host-memory governor and SIGTERM
preemption.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.engine import (DeviceLike, check_on_device,
                                    default_device, to_device)
from bigdl_tpu_torch.nn.attention import (paged_attention,
                                          scaled_dot_product_attention)
from bigdl_tpu_torch.serving.engine import (OUTCOMES, DeadlineExceeded,
                                            Overloaded, ServingDataError,
                                            ServingInfraError, _ServiceEMA)
from bigdl_tpu_torch.serving.kv_cache import DUMP_BLOCK, PagedKVCache
from bigdl_tpu_torch.utils import config

logger = logging.getLogger("bigdl_tpu_torch")

#: columns of the decode step's packed (maxBatch, 3 + maxBlocks) int64
#: input: the fed token, its position, the active flag, the block table
_TOKEN, _POSITION, _ACTIVE, _TABLE = 0, 1, 2, 3


class UnsupportedModelError(ValueError):
    """The served model is not the decoder-only transformer shape this
    engine reads (``models.transformer.transformer_lm``); names the exact
    mismatch, since the silent alternative is a decode path that reads the
    wrong weights."""

    def __init__(self, what: str):
        super().__init__(
            f"LMServingEngine serves transformer_lm-shaped models "
            f"(LookupTable, PositionalEncoding, n x decoder block, "
            f"LayerNorm, Linear, LogSoftMax); {what}")


# ---------------------------------------------------------------------------
# model dissection
# ---------------------------------------------------------------------------


class _LMGraph:
    """Static description of a ``transformer_lm`` model: the modules of each
    block (read through the port's ``Sequential.layers``) and the sizes the
    steps close over."""

    def __init__(self, model):
        import bigdl_tpu_torch.nn as nn
        from bigdl_tpu_torch.models.transformer import (LayerNorm,
                                                        PositionalEncoding,
                                                        _Residual)
        if not isinstance(model, nn.Sequential):
            raise UnsupportedModelError(
                f"got a {type(model).__name__}, not a Sequential")
        ch = list(model.layers)
        if len(ch) < 6:
            raise UnsupportedModelError(
                f"expected >= 6 children, got {len(ch)}")
        embed, pos = ch[0], ch[1]
        lnf, head, logsm = ch[-3], ch[-2], ch[-1]
        if not isinstance(embed, nn.LookupTable):
            raise UnsupportedModelError(
                f"child 0 is {type(embed).__name__}, not LookupTable")
        if getattr(embed, "max_norm", float("inf")) != float("inf"):
            raise UnsupportedModelError(
                "LookupTable max-norm renormalisation is not folded into "
                "the decode path")
        if not isinstance(pos, PositionalEncoding):
            raise UnsupportedModelError(
                f"child 1 is {type(pos).__name__}, not PositionalEncoding")
        if not isinstance(lnf, LayerNorm):
            raise UnsupportedModelError(
                f"child -3 is {type(lnf).__name__}, not the final LayerNorm")
        if not isinstance(head, nn.Linear):
            raise UnsupportedModelError(
                f"child -2 is {type(head).__name__}, not the Linear head")
        if not isinstance(logsm, nn.LogSoftMax):
            raise UnsupportedModelError(
                f"child -1 is {type(logsm).__name__}, not LogSoftMax")
        self.layers: List[Dict[str, Any]] = []
        for bi, blk in enumerate(ch[2:-3]):
            if not (isinstance(blk, nn.Sequential) and len(blk) == 2 and
                    all(isinstance(r, _Residual) for r in blk.layers)):
                raise UnsupportedModelError(
                    f"block {bi} is not a pair of pre-norm residuals")
            attn_res, ffn_res = blk.layers
            ln1, attn = attn_res.layers
            ln2, ffn = ffn_res.layers
            if not isinstance(attn, nn.MultiHeadAttention):
                raise UnsupportedModelError(
                    f"block {bi} residual 0 wraps {type(attn).__name__}, "
                    "not MultiHeadAttention")
            if not attn.causal:
                raise UnsupportedModelError(
                    f"block {bi} attention is not causal: an acausal "
                    "model has no autoregressive decode")
            if not (isinstance(ffn, nn.Sequential) and len(ffn) == 3 and
                    isinstance(ffn.layers[0], nn.Linear) and
                    isinstance(ffn.layers[1], nn.ReLU) and
                    isinstance(ffn.layers[2], nn.Linear)):
                raise UnsupportedModelError(
                    f"block {bi} FFN is not Linear/ReLU/Linear")
            self.layers.append({"ln1": ln1, "attn": attn, "ln2": ln2,
                                "up": ffn.layers[0], "down": ffn.layers[2]})
        if not self.layers:
            raise UnsupportedModelError("model has no decoder blocks")
        heads = {l["attn"].n_head for l in self.layers}
        if len(heads) != 1:
            raise UnsupportedModelError(
                f"heterogeneous head counts across blocks: {sorted(heads)}")
        self.model = model
        self.embed = embed
        self.pos = pos
        self.lnf = lnf
        self.head = head
        self.vocab = int(head.output_size)
        self.vocab_in = int(embed.n_index)
        self.d_model = int(embed.n_output)
        self.n_head = int(self.layers[0]["attn"].n_head)
        self.head_dim = int(self.layers[0]["attn"].head_dim)
        self.n_layers = len(self.layers)
        self.max_seq_len = int(pos.max_seq_len)


def _linear(module) -> Dict[str, Any]:
    """A ``Linear`` as a decode entry: its (out, in) weight read transposed,
    a view, so every entry is applied as ``x @ w`` like the JAX package's
    (in, out) weights."""
    bias = module.bias.detach() if module.with_bias else None
    return {"w": module.weight.detach().t(), "b": bias}


def _norm(module) -> Dict[str, Any]:
    return {"w": module.weight.detach(), "b": module.bias.detach(),
            "eps": module.eps}


def _extract_params(graph: _LMGraph) -> Dict[str, Any]:
    """The decode tree: detached views of the model's parameters (no
    copy), so the steps never build an autograd graph.
    ``MultiHeadAttention`` keeps the JAX package's (in, out) weights;
    ``Linear`` weights are (out, in) and enter transposed."""
    layers = []
    for l in graph.layers:
        attn = l["attn"]
        layers.append({
            "ln1": _norm(l["ln1"]),
            "attn": {w: {"w": getattr(attn, w).detach(),
                         "b": (getattr(attn, "b" + w[-1]).detach()
                               if attn.with_bias else None)}
                     for w in ("wq", "wk", "wv", "wo")},
            "ln2": _norm(l["ln2"]),
            "ffn": {"up": _linear(l["up"]), "down": _linear(l["down"])},
        })
    return {"embed": graph.embed.weight.detach(), "layers": layers,
            "lnf": _norm(graph.lnf), "head": _linear(graph.head)}


def _apply_linear(x: torch.Tensor, e: Dict[str, Any]) -> torch.Tensor:
    y = x @ e["w"]
    if e["b"] is not None:
        y = y + e["b"]
    return y


def _layer_norm(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + p["eps"])
    return out * p["w"] + p["b"]


def _qkv(h: torch.Tensor, attn: Dict[str, Any], shape) -> List[torch.Tensor]:
    return [_apply_linear(h, attn[w]).reshape(shape)
            for w in ("wq", "wk", "wv")]


def _attn_out(x: torch.Tensor, att: torch.Tensor,
              lyr: Dict[str, Any]) -> torch.Tensor:
    """The attention residual, then the FFN residual."""
    bsz, t = att.shape[0], att.shape[1]
    x = x + _apply_linear(att.reshape(bsz, t, -1), lyr["attn"]["wo"])
    h = _layer_norm(x, lyr["ln2"])
    h = torch.relu(_apply_linear(h, lyr["ffn"]["up"]))
    return x + _apply_linear(h, lyr["ffn"]["down"])


def _log_probs(x: torch.Tensor, dp: Dict[str, Any]) -> torch.Tensor:
    """Final LayerNorm, head, log-softmax in fp32."""
    logits = _apply_linear(_layer_norm(x, dp["lnf"]), dp["head"])
    return torch.log_softmax(logits.float(), dim=-1)


def _embed(dp, tokens: torch.Tensor, vocab_in: int) -> torch.Tensor:
    """1-based ids clipped into the table (not range-checked), as the
    JAX package's steps read them."""
    return dp["embed"][(tokens - 1).clamp(0, vocab_in - 1)]


# ---------------------------------------------------------------------------
# step builders (functions of the decode tree; the pools are updated in place)
# ---------------------------------------------------------------------------


def _build_decode_fn(graph: _LMGraph, block_size: int, max_blocks: int):
    """One decode iteration at the fixed ``(maxBatch, 1)`` shape: embedding
    plus each slot's positional row; per layer, this step's k/v scattered
    into the pool BEFORE the gather (the current token attends to itself),
    each sequence's table context gathered, masked paged attention, FFN.
    Returns the next-token log-probs (maxBatch, vocab) in fp32.  Inactive
    slots compute junk that scatters into the dump block and is discarded
    on the host.  Index tensors are int64; ``active`` may be bool or
    int64."""
    pe = graph.pos.pe
    vocab_in = graph.vocab_in
    H, Dh = graph.n_head, graph.head_dim
    S = max_blocks * block_size

    def decode(dp, pool_k, pool_v, tokens, positions, tables, active):
        B = tokens.shape[0]
        dev = tokens.device
        active = active.to(torch.bool)
        x = _embed(dp, tokens, vocab_in)
        x = x + pe[positions][:, None, :].to(x.dtype)
        blk = torch.where(active,
                          tables[torch.arange(B, device=dev),
                                 positions // block_size], DUMP_BLOCK)
        slot = positions % block_size
        valid = ((torch.arange(S, device=dev)[None, :] <=
                  positions[:, None]) & active[:, None])
        for li, lyr in enumerate(dp["layers"]):
            h = _layer_norm(x, lyr["ln1"])
            q, k, v = _qkv(h, lyr["attn"], (B, 1, H, Dh))
            pool_k[li, blk, slot] = k[:, 0]
            pool_v[li, blk, slot] = v[:, 0]
            k_ctx = pool_k[li][tables].reshape(B, S, H, Dh)
            v_ctx = pool_v[li][tables].reshape(B, S, H, Dh)
            x = _attn_out(x, paged_attention(q, k_ctx, v_ctx, valid), lyr)
        return _log_probs(x[:, 0], dp)

    return decode


def _build_prefill_fn(graph: _LMGraph, block_size: int):
    """Bucketed prompt prefill: dense causal attention over the padded
    (1, T) span (padding sits after every real query, so the causal mask
    alone keeps it out of every real row), each real position's k/v
    scattered into the sequence's blocks and each padded one into the dump
    block.  Returns the log-probs (vocab,) of the last real position."""
    pe = graph.pos.pe
    vocab_in = graph.vocab_in
    H, Dh = graph.n_head, graph.head_dim

    def prefill(dp, pool_k, pool_v, tokens, length: int, table):
        T = tokens.shape[1]
        x = _embed(dp, tokens, vocab_in)
        x = x + pe[:T][None].to(x.dtype)
        pos = torch.arange(T, device=tokens.device)
        blkrow = torch.where(pos < length, table[pos // block_size],
                             DUMP_BLOCK)
        slotrow = pos % block_size
        for li, lyr in enumerate(dp["layers"]):
            h = _layer_norm(x, lyr["ln1"])
            q, k, v = _qkv(h, lyr["attn"], (1, T, H, Dh))
            pool_k[li, blkrow, slotrow] = k[0]
            pool_v[li, blkrow, slotrow] = v[0]
            x = _attn_out(x, scaled_dot_product_attention(q, k, v,
                                                          causal=True), lyr)
        return _log_probs(x[0], dp)[length - 1]

    return prefill


def _build_full_fn(graph: _LMGraph):
    """Teacher-forced full forward over a (1, T) span -> (T, vocab)
    log-probs: the sequential baseline and the decode-parity reference
    (prefill's arithmetic without the pool)."""
    pe = graph.pos.pe
    vocab_in = graph.vocab_in
    H, Dh = graph.n_head, graph.head_dim

    def full(dp, tokens):
        T = tokens.shape[1]
        x = _embed(dp, tokens, vocab_in)
        x = x + pe[:T][None].to(x.dtype)
        for lyr in dp["layers"]:
            h = _layer_norm(x, lyr["ln1"])
            q, k, v = _qkv(h, lyr["attn"], (1, T, H, Dh))
            x = _attn_out(x, scaled_dot_product_attention(q, k, v,
                                                          causal=True), lyr)
        return _log_probs(x[0], dp)

    return full


# ---------------------------------------------------------------------------
# streaming handle
# ---------------------------------------------------------------------------


class TokenStream:
    """One admitted generation request: a streaming token iterator and a
    one-shot terminal state that is exactly one of :data:`OUTCOMES`
    (first-wins, so a stream is never both shed by the drain and completed
    by a racing decode).

    Iterating yields tokens as the scheduler emits them; a stream that ends
    with an error (deadline, drain) raises it after the tokens already
    streamed, which stay readable through :meth:`tokens`."""

    __slots__ = ("prompt", "index", "seq_id", "max_new_tokens", "eos_id",
                 "submit_ns", "deadline_ns", "first_token_ns", "finish_ns",
                 "outcome", "_tokens", "_error", "_terminal", "_cv")

    def __init__(self, prompt, index: int, submit_ns: int, deadline_ns: int,
                 max_new_tokens: int, eos_id: Optional[int]):
        self.prompt = prompt
        self.index = index          # admission position
        self.seq_id = index         # KV-cache sequence id
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.submit_ns = submit_ns
        self.deadline_ns = deadline_ns
        self.first_token_ns: Optional[int] = None       # guarded-by: _cv
        self.finish_ns: Optional[int] = None            # guarded-by: _cv
        self.outcome: Optional[str] = None              # guarded-by: _cv
        self._tokens: List[int] = []                    # guarded-by: _cv
        self._error: Optional[BaseException] = None     # guarded-by: _cv
        self._terminal = False                          # guarded-by: _cv
        self._cv = threading.Condition()

    # -- scheduler side ---------------------------------------------------

    def _emit(self, tok: int) -> None:
        with self._cv:
            if self._terminal:
                return
            self._tokens.append(int(tok))
            if self.first_token_ns is None:
                self.first_token_ns = time.monotonic_ns()
            self._cv.notify_all()

    def _finish(self, outcome: str,
                error: Optional[BaseException] = None) -> bool:
        with self._cv:
            if self._terminal:
                return False
            self.outcome = outcome
            self._error = error
            self.finish_ns = time.monotonic_ns()
            self._terminal = True
            self._cv.notify_all()
        return True

    # -- client side ------------------------------------------------------

    def __iter__(self):
        # bounded: at most max_new_tokens yields, then the terminal check
        for i in range(self.max_new_tokens + 1):
            with self._cv:
                while len(self._tokens) <= i and not self._terminal:
                    self._cv.wait(0.05)
                if i >= len(self._tokens):
                    break
                tok = self._tokens[i]
            yield tok
        if self._error is not None:
            raise self._error

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; the full token list, or raises the
        terminal error (the tokens streamed before it stay readable through
        :meth:`tokens`)."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cv:
            while not self._terminal:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"stream {self.index} still in flight after "
                        f"{timeout} s")
                self._cv.wait(0.05)
        if self._error is not None:
            raise self._error
        return list(self._tokens)

    def tokens(self) -> List[int]:
        """Tokens streamed so far (a snapshot; does not block)."""
        with self._cv:
            return list(self._tokens)

    def done(self) -> bool:
        return self._terminal

    def error(self) -> Optional[BaseException]:
        return self._error if self._terminal else None

    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ns is None:
            return None
        return (self.first_token_ns - self.submit_ns) / 1e6

    def latency_ms(self) -> Optional[float]:
        if self.finish_ns is None:
            return None
        return (self.finish_ns - self.submit_ns) / 1e6


class _Slot:
    """One occupied decode slot: the stream and its cursor (``position`` =
    the pool position the NEXT fed token writes)."""

    __slots__ = ("stream", "position", "generated", "last_token",
                 "table_row")

    def __init__(self, stream: TokenStream, position: int, last_token: int,
                 table_row: np.ndarray):
        self.stream = stream
        self.position = position
        self.generated = 1          # prefill emitted the first token
        self.last_token = last_token
        self.table_row = table_row


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class LMServingEngine:
    """Continuous-batching token server over one decoder-only LM, which must
    already lie on ``device`` (default ``"cuda"``; the tests pass
    ``"cpu"``).

    All knobs default from ``bigdl.lm.*``; constructor arguments override
    per engine.  :meth:`submit` streams; :meth:`generate` and
    :meth:`generate_sequential` are the offline paged / teacher-forced pair
    that the parity checks and the throughput baseline use."""

    def __init__(self, model, max_batch: Optional[int] = None,
                 max_context: Optional[int] = None,
                 block_size: Optional[int] = None,
                 cache_blocks: Optional[int] = None,
                 max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_queue_depth: Optional[int] = None,
                 quantize: Optional[str] = None,
                 start: bool = False, device: DeviceLike = "cuda"):
        self.device = default_device(device)
        self.graph = _LMGraph(model)
        check_on_device(model, self.device)
        self.max_batch = int(max_batch if max_batch is not None else
                             config.get_int("bigdl.lm.maxBatch", 8))
        self.max_context = int(
            max_context if max_context is not None else
            config.get_int("bigdl.lm.maxContext", 256))
        self.block_size = int(
            block_size if block_size is not None else
            config.get_int("bigdl.lm.blockSize", 16))
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None else
            config.get_int("bigdl.lm.maxNewTokens", 64))
        self.deadline_ms = float(
            deadline_ms if deadline_ms is not None else
            config.get_float("bigdl.lm.deadlineMs", 5000.0))
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None else
            config.get_int("bigdl.lm.maxQueueDepth", 128))
        self.admission_factor = config.get_float(
            "bigdl.lm.admissionDeadlineFactor", 0.0)
        self.warmup_steps = config.get_int("bigdl.lm.warmupSteps", 3)
        self.grace_period = config.get_float("bigdl.lm.gracePeriod", 5.0)
        self.poll_interval = config.get_float("bigdl.lm.pollInterval", 0.01)
        quant = str(quantize if quantize is not None else
                    config.get_property("bigdl.lm.quantize", "off")
                    or "off").lower()
        if quant not in ("off", "int8"):
            raise ValueError(
                f"bigdl.lm.quantize must be 'off' or 'int8', got {quant!r}")
        if quant == "int8":
            raise NotImplementedError(
                "the int8 decode tier (bigdl.lm.quantize=int8) and its gate "
                "are not ported yet")
        if config.get_float("bigdl.lm.stallFactor", 0.0) > 0:
            raise NotImplementedError(
                "the hung-decode watchdog (bigdl.lm.stallFactor > 0) is not "
                "ported yet")
        if self.max_context > self.graph.max_seq_len:
            raise ValueError(
                f"bigdl.lm.maxContext {self.max_context} exceeds the "
                f"model's PositionalEncoding max_len "
                f"{self.graph.max_seq_len}: build the model with a larger "
                "max_len or lower maxContext")
        if self.max_batch < 1 or self.max_new_tokens < 1:
            raise ValueError("maxBatch and maxNewTokens must be >= 1")

        # -- KV pool: sized once, preflighted against free device memory --
        self._max_blocks = max(1, math.ceil(self.max_context /
                                            self.block_size))
        n_blocks = int(cache_blocks if cache_blocks is not None else
                       config.get_int("bigdl.lm.cacheBlocks", 0))
        if n_blocks <= 0:
            n_blocks = self.max_batch * self._max_blocks + 1
        self.cache = PagedKVCache(self.graph.n_layers, self.graph.n_head,
                                  self.graph.head_dim, n_blocks,
                                  self.block_size, device=self.device)
        self._buckets = self._bucket_plan(
            config.get_property("bigdl.lm.prefillBuckets", None))

        # -- steps; the decode graph is captured at warmup or first use ---
        self._dp = _extract_params(self.graph)
        self._decode_fn = _build_decode_fn(self.graph, self.block_size,
                                           self._max_blocks)
        self._prefill_fn = _build_prefill_fn(self.graph, self.block_size)
        self._full_fn = _build_full_fn(self.graph)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_in: Optional[torch.Tensor] = None
        self._graph_out: Optional[torch.Tensor] = None
        self.decode_captures = 0

        # -- scheduler state ----------------------------------------------
        self._q: "queue.Queue[TokenStream]" = queue.Queue(
            maxsize=self.max_queue_depth)
        self._pending: "deque[TokenStream]" = deque(   # guarded-by: _lock
            maxlen=self.max_queue_depth)
        self._slots: List[Optional[_Slot]] = [None] * self.max_batch
        # the stream mid-admission: popped from the queue, not yet slotted;
        # _shed_active covers it so it never lives only in a local
        self._admitting: Optional[TokenStream] = None
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(OUTCOMES, 0)  # guarded-by: _lock
        self._counts["submitted"] = 0
        self._next_index = 0                            # guarded-by: _lock
        self._offline_id = 0
        self._draining = False                          # guarded-by: _lock
        self._drain_deadline: Optional[float] = None    # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        self._started = False                           # guarded-by: _lock
        self._stop_event = threading.Event()
        self._ema = _ServiceEMA(self.warmup_steps)
        self.decode_steps = 0
        self.prefills = 0                               # guarded-by: _lock
        self.tokens_out = 0
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- step plan --------------------------------------------------------

    def _bucket_plan(self, spec) -> List[int]:
        """Prefill shape ladder: ``bigdl.lm.prefillBuckets`` or a power-of-
        two ladder from blockSize up; maxContext is always in the plan."""
        if spec:
            buckets = sorted({int(b) for b in str(spec).split(",") if
                              str(b).strip()})
            if not buckets or buckets[0] < 1:
                raise ValueError(
                    f"bigdl.lm.prefillBuckets must be positive ints, got "
                    f"{spec!r}")
            if buckets[-1] > self.max_context:
                raise ValueError(
                    f"bigdl.lm.prefillBuckets {buckets[-1]} exceeds "
                    f"bigdl.lm.maxContext {self.max_context}")
        else:
            buckets, b = [], max(1, self.block_size)
            for _ in range(64):
                if b >= self.max_context:
                    break
                buckets.append(b)
                b *= 2
        return sorted(set(buckets + [self.max_context]))

    def _prefill_bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    @property
    def sentinels(self):
        raise NotImplementedError(
            "retrace sentinels are not ported yet (analysis/retrace.py); "
            "decode_captures counts the decode graph's captures")

    def warmup(self) -> None:
        """Run every planned step once (prefill and the full forward at
        each bucket, all rows scattering into the dump block, and the
        decode step at its one shape, all slots inactive), so no request
        pays a first call against its deadline.  On a CUDA device this
        captures the decode graph."""
        table = torch.full((self._max_blocks,), DUMP_BLOCK,
                           dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for b in self._buckets:
                tokens = torch.ones((1, b), dtype=torch.int64,
                                    device=self.device)
                self._prefill_fn(self._dp, self.cache.k, self.cache.v,
                                 tokens, 0, table)
                self._full_fn(self._dp, tokens)
        self._decode_step(self._idle_inputs())

    # -- the decode step --------------------------------------------------

    def _idle_inputs(self) -> np.ndarray:
        """The decode step's packed host input with every slot inactive:
        token 1 at position 0, tables all dump block."""
        inputs = np.zeros((self.max_batch, _TABLE + self._max_blocks),
                          np.int64)
        inputs[:, _TOKEN] = 1
        inputs[:, _TABLE:] = DUMP_BLOCK
        return inputs

    def _run_decode(self, pool_k: torch.Tensor, pool_v: torch.Tensor,
                    inputs: torch.Tensor) -> torch.Tensor:
        """The decode step, eagerly, on a packed device input."""
        return self._decode_fn(self._dp, pool_k, pool_v,
                               inputs[:, _TOKEN:_TOKEN + 1],
                               inputs[:, _POSITION], inputs[:, _TABLE:],
                               inputs[:, _ACTIVE])

    def _capture_decode(self) -> None:
        """Capture the decode step as one CUDA graph over a static input
        buffer and the live pools.  One eager run on a side stream first,
        all slots inactive (it writes only the dump block), so the capture
        records warm kernels; the capture itself runs nothing."""
        dev = self.device
        static_in = to_device(self._idle_inputs(), dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.no_grad():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run_decode(self.cache.k, self.cache.v, static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self._run_decode(self.cache.k, self.cache.v,
                                              static_in)
        self._graph, self._graph_in, self._graph_out = (graph, static_in,
                                                        static_out)
        self.decode_captures += 1

    def _decode_step(self, inputs: np.ndarray) -> np.ndarray:
        """One decode step from the packed host ``inputs``; the
        (maxBatch, vocab) log-probs on the host.  On a CUDA device: copy
        into the graph's static input, replay, pull (capturing the graph
        first if warmup did not)."""
        if self.device.type == "cuda":
            if self._graph is None:
                self._capture_decode()
            with torch.cuda.device(self.device):
                self._graph_in.copy_(torch.from_numpy(inputs))
                self._graph.replay()
                return self._graph_out.cpu().numpy()
        with torch.no_grad():
            return self._run_decode(self.cache.k, self.cache.v,
                                    torch.from_numpy(inputs)).numpy()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "LMServingEngine":
        if self._closed:
            raise ServingInfraError(
                "engine is terminal: stop() is one-way; build a new engine "
                "instead of restarting this one")
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        daemon=True, name="lm-scheduler")
        self._thread.start()
        return self

    def stop(self, grace: Optional[float] = None) -> None:
        """Graceful shutdown, idempotent and terminal: admission closes,
        queued prompts and in-flight sequences drain within ``grace``
        (default ``bigdl.lm.gracePeriod``), leftovers are shed retriably
        and the scheduler thread is joined."""
        if not self._started or self._closed:
            with self._lock:
                self._closed = True
            self._drain_leftovers()
            return
        with self._lock:
            if not self._draining:
                self._begin_drain_locked(time.monotonic(), grace)
            elif grace is not None:
                self._drain_deadline = time.monotonic() + grace
        self._stop_event.set()
        t = self._thread
        if t is not None:
            budget = grace if grace is not None else self.grace_period
            t.join(timeout=budget + 10.0)
        self._drain_leftovers()
        with self._lock:
            self._closed = True

    def close(self) -> None:
        self.stop()

    def __enter__(self) -> "LMServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def terminal(self) -> bool:
        return self._closed

    @property
    def draining(self) -> bool:
        return self._draining

    def queue_depth(self) -> int:
        return self._q.qsize() + len(self._pending)

    def scheduler_alive(self) -> bool:
        t = self._thread
        return bool(t is not None and t.is_alive())

    # -- admission --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               eos_id: Optional[int] = None) -> TokenStream:
        """Admit one prompt (1-D integer token ids, 1-based) or raise
        :class:`Overloaded`, fast, at the door.  Returns its
        :class:`TokenStream`."""
        now = time.monotonic_ns()
        deadline = float(deadline_ms if deadline_ms is not None
                         else self.deadline_ms)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        with self._lock:
            self._counts["submitted"] += 1
            if self._closed or (self._stop_event.is_set() and
                                not self._draining):
                raise self._reject_locked("closed")
            if self._draining:
                raise self._reject_locked("draining")
            depth = self._q.qsize() + len(self._pending)
            if depth >= self.max_queue_depth:
                raise self._reject_locked("queue full", depth)
            n = getattr(prompt, "shape", None)
            n = (int(np.prod(n)) if n is not None
                 else len(prompt) if hasattr(prompt, "__len__") else None)
            if (n is not None and self.cache.blocks_for(n + max_new) >
                    self.cache.allocatable_blocks):
                # can NEVER be scheduled: larger than the whole pool
                raise self._reject_locked("kv blocks exhausted", depth)
            if self.admission_factor > 0:
                ema = self._ema.ema
                if ema is not None:
                    waves = math.ceil((depth + 1) / self.max_batch)
                    projected = waves * ema * max_new
                    if projected > self.admission_factor * deadline:
                        raise self._reject_locked(
                            "projected wait", depth,
                            projected_wait_ms=projected,
                            deadline_ms=deadline)
            stream = TokenStream(prompt, self._next_index, now,
                                 now + int(deadline * 1e6), max_new, eos_id)
            self._next_index += 1
        try:
            self._q.put_nowait(stream)
        except queue.Full:
            with self._lock:
                raise self._reject_locked("queue full",
                                          self.max_queue_depth)
        if self._closed:
            # the scheduler exited between the admission check and the
            # enqueue (it marks _closed before its final sweep): shed now
            self._drain_leftovers()
        return stream

    def _reject_locked(self, reason: str, depth: Optional[int] = None,
                       **kw) -> Overloaded:
        self._counts["rejected"] += 1
        return Overloaded(reason,
                          queue_depth=(depth if depth is not None
                                       else self.queue_depth()),
                          max_depth=self.max_queue_depth, **kw)

    def _validate(self, stream: TokenStream) -> np.ndarray:
        """Per-request prompt validation: anything wrong with the PAYLOAD
        raises :class:`ServingDataError` here and quarantines one stream."""
        try:
            row = np.asarray(stream.prompt)
        except Exception as e:
            raise ServingDataError(
                f"undecodable prompt payload: {e!r}") from e
        if row.ndim != 1 or row.size == 0:
            raise ServingDataError(
                f"prompt must be a non-empty 1-D token-id sequence, got "
                f"shape {row.shape}")
        if not np.issubdtype(row.dtype, np.integer):
            raise ServingDataError(
                f"prompt token ids must be integers, got dtype "
                f"{row.dtype}")
        if row.size + stream.max_new_tokens > self.max_context:
            raise ServingDataError(
                f"prompt of {row.size} token(s) + max_new_tokens "
                f"{stream.max_new_tokens} exceeds bigdl.lm.maxContext "
                f"{self.max_context}")
        return row.astype(np.int64)

    # -- accounting -------------------------------------------------------

    def _finish_stream(self, stream: TokenStream, outcome: str,
                       error: Optional[BaseException] = None) -> bool:
        if not stream._finish(outcome, error=error):
            return False
        with self._lock:
            self._counts[outcome] += 1
        return True

    def stats(self) -> Dict[str, Any]:
        """Outcome counters and the accounting identity residual
        (``unaccounted`` includes streams still in flight: quiesce first
        for the exact identity)."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counts)
            out["prefills"] = self.prefills
        out["unaccounted"] = out["submitted"] - sum(out[o]
                                                    for o in OUTCOMES)
        out["decode_steps"] = self.decode_steps
        out["tokens_out"] = self.tokens_out
        out["decode_captures"] = self.decode_captures
        out["queue_depth"] = self.queue_depth()
        out["decode_ema_ms"] = self._ema.ema
        out["draining"] = self._draining
        out["active_slots"] = sum(s is not None for s in self._slots)
        out["free_blocks"] = self.cache.free_blocks
        out["used_blocks"] = self.cache.used_blocks
        return out

    # -- the scheduler thread ---------------------------------------------

    def _any_active(self) -> bool:
        return any(s is not None for s in self._slots)

    def _scheduler_loop(self) -> None:
        try:
            drained = False
            while not drained:
                if not self._draining and self._stop_event.is_set():
                    with self._lock:
                        self._begin_drain_locked(time.monotonic())
                if self._draining:
                    if time.monotonic() > self._drain_deadline:
                        self._drain_leftovers()
                        self._shed_active(ServingInfraError(
                            "engine draining: decode did not finish "
                            "within the grace period; retriable"),
                            "drained")
                        drained = True
                        continue
                    if (self._q.empty() and not self._pending and
                            not self._any_active()):
                        drained = True
                        continue
                active = True
                try:
                    self._admit_waiting()
                    active = self._any_active()
                    if active:
                        self._decode_iteration()
                except Exception as e:  # noqa: BLE001 — must outlive
                    logger.exception("LM scheduler iteration failed")
                    self._shed_active(ServingInfraError(
                        f"decode failed: {e!r}"), "infra")
                if not active:
                    try:
                        stream = self._q.get(timeout=self.poll_interval)
                        with self._lock:
                            self._pending.append(stream)
                    except queue.Empty:
                        pass
        finally:
            # _closed BEFORE the sweep: a racing submit either observes
            # _closed (and sheds its own stream) or enqueued before this
            # sweep, which sheds it
            with self._lock:
                self._closed = True
            self._drain_leftovers()
            self._shed_active(ServingInfraError(
                "scheduler exited with the sequence in flight; retriable"),
                "infra")

    def _begin_drain_locked(self, started_at: float,
                            grace: Optional[float] = None) -> None:
        budget = grace if grace is not None else self.grace_period
        # deadline published BEFORE the flag (lock-free readers)
        self._drain_deadline = started_at + budget
        self._draining = True
        logger.info("LM engine draining: grace %.1f s, %d queued, %d active",
                    budget, self.queue_depth(),
                    sum(s is not None for s in self._slots))

    def _drain_leftovers(self) -> None:
        """Shed everything still waiting (the queue and the block-starved
        holdover), retriably.  Both are capped at ``maxQueueDepth``."""
        shed = 0
        for src in ("queue", "pending"):
            for _ in range(self.max_queue_depth + 1):
                if src == "queue":
                    try:
                        stream = self._q.get_nowait()
                    except queue.Empty:
                        break
                else:
                    try:
                        with self._lock:
                            stream = self._pending.popleft()
                    except IndexError:
                        break
                err = ServingInfraError(
                    "engine draining: prompt was not scheduled within the "
                    "grace period; retriable")
                shed += self._finish_stream(stream, "shed", error=err)
        if shed:
            logger.warning("LM drain shed %d queued stream(s)", shed)

    def _shed_active(self, error: Exception, reason: str) -> None:
        """Fail every in-flight sequence with the diagnosis and free its
        blocks; each victim gets its own exception instance."""
        failed = 0
        victims = [s.stream for s in self._slots if s is not None]
        self._slots = [None] * self.max_batch
        if self._admitting is not None:
            victims.append(self._admitting)
            self._admitting = None
        for stream in victims:
            # free_seq and _finish_stream are both idempotent
            self.cache.free_seq(stream.seq_id)
            failed += self._finish_stream(stream, "shed",
                                          error=type(error)(*error.args))
        if failed:
            logger.error("LM decode aborted (%s): %d in-flight stream(s) "
                         "failed with %s", reason, failed,
                         type(error).__name__)

    def _admit_waiting(self) -> None:
        """Fill vacant decode slots from the holdover, then the queue:
        expired prompts are shed and poison ones quarantined (neither takes
        a slot); a block-starved prompt goes back to the FRONT of the
        holdover and admission stops until a finishing sequence frees
        blocks."""
        for _ in range(self.max_batch):
            slot_idx = next((i for i, s in enumerate(self._slots)
                             if s is None), None)
            if slot_idx is None:
                return
            stream = None
            with self._lock:
                if self._pending:
                    stream = self._pending.popleft()
            if stream is None:
                try:
                    stream = self._q.get_nowait()
                except queue.Empty:
                    return
            self._admitting = stream
            now = time.monotonic_ns()
            if now > stream.deadline_ns:
                waited = (now - stream.submit_ns) / 1e6
                deadline = (stream.deadline_ns - stream.submit_ns) / 1e6
                self._finish_stream(stream, "shed",
                                    error=DeadlineExceeded(waited, deadline))
                self._admitting = None
                continue
            try:
                prompt = self._validate(stream)
            except ServingDataError as e:
                self._finish_stream(stream, "quarantined", error=e)
                self._admitting = None
                continue
            need = prompt.size + stream.max_new_tokens
            if not self.cache.can_allocate(need):
                with self._lock:
                    self._pending.appendleft(stream)
                self._admitting = None
                return
            self.cache.allocate(stream.seq_id, need)
            try:
                tok, table_row = self._prefill_step_raw(stream.seq_id,
                                                        prompt)
            except Exception as e:  # noqa: BLE001 — fail one stream
                logger.exception("LM prefill failed")
                self.cache.free_seq(stream.seq_id)
                self._finish_stream(stream, "shed", error=ServingInfraError(
                    f"prefill failed: {e!r}"))
                self._admitting = None
                continue
            stream._emit(tok)
            self.tokens_out += 1
            if ((stream.eos_id is not None and tok == stream.eos_id) or
                    stream.max_new_tokens <= 1):
                self.cache.free_seq(stream.seq_id)
                self._finish_stream(stream, "completed")
                self._admitting = None
                continue
            self._slots[slot_idx] = _Slot(stream, int(prompt.size), tok,
                                          table_row)
            self._admitting = None

    def _prefill_step_raw(self, seq_id: int, prompt: np.ndarray
                          ) -> Tuple[int, np.ndarray]:
        """The bucketed prefill of an ALLOCATED sequence: scatter the
        prompt's k/v into its blocks; return the first greedy token
        (1-based) and the dump-padded table row the decode step gathers
        through."""
        P = int(prompt.size)
        bucket = self._prefill_bucket(P)
        padded = np.ones((1, bucket), np.int64)
        padded[0, :P] = prompt
        blocks = self.cache.table(seq_id)
        table_row = np.full((self._max_blocks,), DUMP_BLOCK, np.int64)
        table_row[:len(blocks)] = blocks
        with torch.no_grad():
            lp = self._prefill_fn(self._dp, self.cache.k, self.cache.v,
                                  to_device(padded, self.device), P,
                                  to_device(table_row, self.device))
        lp = lp.cpu().numpy()
        with self._lock:
            self.prefills += 1
        return int(np.argmax(lp)) + 1, table_row

    def _decode_iteration(self) -> None:
        """ONE decode step over every occupied slot: the continuous-batching
        heartbeat.  Finished sequences vacate their slot and free their
        blocks before the next admission pass."""
        self.decode_steps += 1
        t0 = time.monotonic_ns()
        inputs = self._idle_inputs()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            inputs[i, _TOKEN] = slot.last_token
            inputs[i, _POSITION] = slot.position
            inputs[i, _ACTIVE] = 1
            inputs[i, _TABLE:] = slot.table_row
        lp = self._decode_step(inputs)
        now = time.monotonic_ns()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            stream = slot.stream
            tok = int(np.argmax(lp[i])) + 1
            slot.position += 1
            slot.generated += 1
            slot.last_token = tok
            stream._emit(tok)
            self.tokens_out += 1
            if ((stream.eos_id is not None and tok == stream.eos_id) or
                    slot.generated >= stream.max_new_tokens):
                # finish FIRST: a slot cleared before its stream finishes
                # would leave the stream unaccounted if anything raised
                self._finish_stream(stream, "completed")
                self._slots[i] = None
                self.cache.free_seq(stream.seq_id)
            elif now > stream.deadline_ns:
                # expiry AFTER the emit: the streamed prefix stays with the
                # client, the terminal error says why it stopped
                waited = (now - stream.submit_ns) / 1e6
                deadline = (stream.deadline_ns - stream.submit_ns) / 1e6
                self._finish_stream(stream, "shed",
                                    error=DeadlineExceeded(waited, deadline))
                self._slots[i] = None
                self.cache.free_seq(stream.seq_id)
        self._ema.observe((time.monotonic_ns() - t0) / 1e6)

    # -- offline generation (parity and baseline) --------------------------

    def _offline_seq_id(self) -> int:
        # negative ids never collide with a stream's admission index
        self._offline_id -= 1
        return self._offline_id

    def _check_prompt(self, prompt, max_new_tokens: Optional[int]
                      ) -> Tuple[np.ndarray, int]:
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ServingDataError(
                f"prompt must be a non-empty 1-D token-id sequence, got "
                f"shape {prompt.shape}")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        if prompt.size + max_new > self.max_context:
            raise ServingDataError(
                f"prompt of {prompt.size} token(s) + max_new_tokens "
                f"{max_new} exceeds bigdl.lm.maxContext {self.max_context}")
        return prompt.astype(np.int64), max_new

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None, return_logps: bool = False):
        """Offline greedy generation through the PAGED path (prefill, then
        single-token decode steps over the block table): the steps the
        scheduler runs, without the scheduler.  Refused while the scheduler
        runs (it owns the slots and pools)."""
        if self._started:
            raise ServingInfraError(
                "generate() is the offline path: the scheduler owns the "
                "decode slots once start() has run; use submit()")
        prompt, max_new = self._check_prompt(prompt, max_new_tokens)
        seq_id = self._offline_seq_id()
        self.cache.allocate(seq_id, int(prompt.size) + max_new)
        try:
            tok, table_row = self._prefill_step_raw(seq_id, prompt)
            out_tokens = [tok]
            logps: List[np.ndarray] = []
            position = int(prompt.size)
            for _ in range(max_new - 1):
                if eos_id is not None and out_tokens[-1] == eos_id:
                    break
                inputs = self._idle_inputs()
                inputs[0, _TOKEN] = out_tokens[-1]
                inputs[0, _POSITION] = position
                inputs[0, _ACTIVE] = 1
                inputs[0, _TABLE:] = table_row
                row = self._decode_step(inputs)[0]
                out_tokens.append(int(np.argmax(row)) + 1)
                logps.append(row)
                position += 1
        finally:
            self.cache.free_seq(seq_id)
        return (out_tokens, logps) if return_logps else out_tokens

    def generate_sequential(self, prompt,
                            max_new_tokens: Optional[int] = None,
                            eos_id: Optional[int] = None,
                            return_logps: bool = False):
        """The baseline without a KV cache: one teacher-forced full forward
        over the whole growing sequence per emitted token.  Greedy tokens
        equal :meth:`generate`'s; log-probs agree to allclose (the sums are
        shaped differently).  Only the row of the last position crosses to
        the host."""
        prompt, max_new = self._check_prompt(prompt, max_new_tokens)
        seq = [int(t) for t in prompt]
        out_tokens: List[int] = []
        logps: List[np.ndarray] = []
        for _ in range(max_new):
            if (eos_id is not None and out_tokens and
                    out_tokens[-1] == eos_id):
                break
            t = len(seq)
            padded = np.ones((1, self._prefill_bucket(t)), np.int64)
            padded[0, :t] = seq
            with torch.no_grad():
                lp = self._full_fn(self._dp, to_device(padded, self.device))
            row = lp[t - 1].cpu().numpy()
            tok = int(np.argmax(row)) + 1
            seq.append(tok)
            out_tokens.append(tok)
            logps.append(row)
        return (out_tokens, logps) if return_logps else out_tokens


__all__ = ["LMServingEngine", "PagedKVCache", "TokenStream",
           "UnsupportedModelError"]
