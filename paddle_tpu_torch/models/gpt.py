"""GPT decoder-only LM: the port of ``paddle_tpu/models/gpt.py`` (the
flagship; BASELINE.json config 3: GPT-3 1.3B), built from the port's
``nn`` layers.

``GPTConfig`` is the port's own copy (same fields and defaults, same named
configurations). Attention goes through ``F.scaled_dot_product_attention``
(causal), which takes the library tier's Hopper kernels on the card. The
decode path (the ``caches`` argument, ``init_cache``,
``forward_with_cache``, ``generate``) is the reference's: learned positions
continue from the cache lengths and ``inference.decode.cache_attention``
writes k/v into the fixed-capacity cache in place.

``use_tensor_parallel`` builds the reference's fleet layers: ``qkv`` and
``fc1`` column-parallel, ``proj`` and ``fc2`` row-parallel, ``wte``
vocab-parallel. Each rank holds its shards and attends over its own
``num_heads / tp`` heads: ``qkv`` is ``ColumnParallelLinear(segments=3)``,
whose shard holds this rank's heads' q, k and v columns (the reference's
contiguous GSPMD shard straddles q|k|v; ``set_global_params`` and
``gather_global_params`` take and give the reference's global layout). The
tied head multiplies by this rank's vocab rows and gathers the shards
differentiably, so ``forward`` returns global logits, as the reference's.
Without a model-parallel group the layers are their dense counterparts.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_mult: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    use_tensor_parallel: bool = False

    @staticmethod
    def gpt3_1p3b():
        return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                         num_heads=16, max_seq_len=2048)

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=64)


def _fleet():
    from paddle_tpu_torch.distributed import fleet
    return fleet


class GPTAttention(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        if cfg.use_tensor_parallel:
            fleet = _fleet()
            self.qkv = fleet.ColumnParallelLinear(h, 3 * h,
                                                  gather_output=False,
                                                  segments=3)
            self.proj = fleet.RowParallelLinear(h, h,
                                                input_is_parallel=True)
            group = self.qkv._group
            tp = 1 if group is None else group.nranks
            if cfg.num_heads % tp:
                raise ValueError(
                    f"GPT tensor parallelism: num_heads={cfg.num_heads} is "
                    f"not divisible by the {tp} model-parallel ranks")
            self.num_heads = cfg.num_heads // tp
        else:
            self.qkv = nn.Linear(h, 3 * h)
            self.proj = nn.Linear(h, h)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None):
        b, s, _ = x.shape
        nh = self.num_heads          # this rank's heads
        d = self.cfg.hidden_size // self.cfg.num_heads
        h = nh * d
        qkv = self.qkv(x).reshape([b, s, 3, nh, d])
        q, k, v = qkv.unbind(axis=2)
        if cache is not None:
            # fixed-capacity decode path (inference/decode.py): write
            # k/v at the cache lengths, attend with the length mask
            from paddle_tpu_torch.inference.decode import cache_attention
            out, cache = cache_attention(q, k, v, cache)
            out = out.reshape([b, s, h])
            return self.drop(self.proj(out)), cache
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.cfg.dropout, training=self.training)
        out = out.reshape([b, s, h])
        return self.drop(self.proj(out))


class GPTMLP(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h, m = cfg.hidden_size, cfg.hidden_size * cfg.ffn_mult
        if cfg.use_tensor_parallel:
            fleet = _fleet()
            self.fc1 = fleet.ColumnParallelLinear(h, m, gather_output=False)
            self.fc2 = fleet.RowParallelLinear(m, h, input_is_parallel=True)
        else:
            self.fc1 = nn.Linear(h, m)
            self.fc2 = nn.Linear(m, h)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.drop(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTBlock(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size)
        self.mlp = GPTMLP(cfg)

    def forward(self, x, cache=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache)
            x = x + a
            x = x + self.mlp(self.ln2(x))
            return x, cache
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class GPTModel(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.use_tensor_parallel:
            self.wte = _fleet().VocabParallelEmbedding(cfg.vocab_size,
                                                       cfg.hidden_size)
        else:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.drop = nn.Dropout(cfg.dropout)
        self.blocks = nn.LayerList([GPTBlock(cfg)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias_attr=False)

    def forward(self, input_ids, caches=None):
        b, s = input_ids.shape
        if caches is not None:
            # learned positions continue from the per-sequence cache
            # lengths (all layer caches share one length counter). A slot
            # the continuous-batching step masks may sit at the capacity:
            # its discarded row stays inside the table, where the
            # reference's gather reads NaN (jnp.take's "fill"), which its
            # dead k/v then carry into the slot's next request.
            pos = (caches[0].length.unsqueeze(1) +
                   paddle.arange(s, dtype="int64").unsqueeze(0)).clip(
                       max=self.cfg.max_seq_len - 1)
        else:
            pos = paddle.arange(s, dtype="int64").unsqueeze(0)
        x = self.wte(input_ids) + self.wpe(pos)
        x = self.drop(x)
        if caches is not None:
            new_caches = []
            for blk, c in zip(self.blocks, caches):
                x, c = blk(x, c)
                new_caches.append(c)
            caches = new_caches
        else:
            for blk in self.blocks:
                x = blk(x)
        x = self.ln_f(x)
        if self.cfg.tie_embeddings:
            logits = self._tied_head(x)
        else:
            logits = self.lm_head(x)
        return logits if caches is None else (logits, caches)

    def _tied_head(self, x):
        """x times the embedding's transpose: global logits. A
        vocab-parallel ``wte`` gives this rank's vocab columns, gathered
        differentiably (Megatron's f on x, since x is the same on every
        rank, and an all-gather whose backward keeps this rank's chunk)."""
        group = getattr(self.wte, "_group", None)
        if group is None:
            return paddle.matmul(x, self.wte.weight, transpose_y=True)
        from paddle_tpu_torch.core.dispatch import run_op
        from paddle_tpu_torch.distributed import collective as C

        def f(a, w):
            out = torch.matmul(C._Pvary.apply(a, group), w.t())
            return C._GatherInvariant.apply(out, group, out.dim() - 1)
        return run_op("matmul", f, x, self.wte.weight)   # AMP: as matmul

    def init_cache(self, batch_size, max_length):
        from paddle_tpu_torch.inference.decode import init_static_cache
        d = self.cfg.hidden_size // self.cfg.num_heads
        return [init_static_cache(batch_size, max_length,
                                  self.blocks[0].attn.num_heads, d)
                for _ in range(self.cfg.num_layers)]


class GPTForCausalLM(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.gpt = GPTModel(cfg)
        self.loss_fn = nn.CrossEntropyLoss()

    def forward(self, input_ids, labels=None):
        logits = self.gpt(input_ids)
        if labels is None:
            return logits
        return self.loss_fn(
            logits[:, :-1].reshape([-1, logits.shape[-1]]),
            labels[:, 1:].reshape([-1]))

    def init_cache(self, batch_size, max_length=None):
        return self.gpt.init_cache(batch_size, max_length or
                                   self.gpt.cfg.max_seq_len)

    def forward_with_cache(self, input_ids, caches):
        """DecodeSession contract: (ids, caches) -> (logits, caches)."""
        return self.gpt(input_ids, caches)

    @paddle.no_grad()
    def generate(self, input_ids, max_new_tokens=16, temperature=0.0,
                 top_p=None, seed=None, max_length=None,
                 decode_block=None):
        """Static-shape generation over the fixed-capacity KV cache (see
        inference/decode.py)."""
        from paddle_tpu_torch.inference.decode import cached_generate
        self.eval()
        # learned wpe table: positions past max_seq_len are a hard error
        return cached_generate(self, input_ids, max_new_tokens,
                               temperature=temperature, top_p=top_p,
                               seed=seed, max_length=max_length,
                               decode_block=decode_block,
                               seq_ceiling=self.gpt.cfg.max_seq_len,
                               hard_limit=True)
