"""Encoder-decoder transformer: the port of flashy_tpu/models/seq2seq.py.

The encoder is the port's `transformer.Block` with `causal=False`; each
decoder block adds one cross-attention sublayer between its causal
self-attention and its MLP: a `q` projection of the decoder stream and
one fused `kv` projection of the encoder memory, unmasked plain attention
(`ops.attention.dot_product_attention`, as the JAX package's cross
attention is), no positions. One embedding table serves the source, the
target and the tied f32 head. Parameters keep the flax tree's names
(`embed`, `enc_blocks_{i}`, `enc_norm`, `dec_blocks_{i}` with `norm1`,
`attn`, `norm2`, `xattn`, `norm3`, `mlp`, `dec_norm`), so
`models.convert.seq2seq_from_jax` carries a JAX model across.

With `attention='flash'` the self-attention of both stacks runs the
Hopper flash kernels on CUDA: the encoder non-causal, the decoder
causal; a sequence of 64 is one of their 64-row tiles, where the JAX
package, whose kernel tiles by 128, takes dense attention.

Generation: `greedy_translate` re-runs the decoder over a growing buffer
(O(T^2), the oracle); `cached_translate` runs the encoder once,
precomputes each block's cross K/V once, and steps one token at a time
against per-block self-attention caches through `models.decoding`'s
`_cached_self_attention` and `_gated_mlp`, with a plain cross softmax.
"""
import dataclasses
import typing as tp

import numpy as np
import torch
from torch import nn

from ..ops.attention import dot_product_attention, score_scale
from ..parallel.mesh import Mesh
from ..parallel.tensor import (copy_to_tensor, layer_mesh,
                               reduce_from_tensor, vocab_parallel_embedding)
from ..utils import resolve_device
from .transformer import (DROPOUT_MIXER, DROPOUT_MLP, Attention, Block,
                          DropoutSeed, MLPBlock, RMSNorm, TransformerConfig,
                          _Kernel, _param, dropout, fold_dropout_seed,
                          rmsnorm, training_dropout_seed)

DROPOUT_CROSS = 2     # the decoder's third dropout site, after xattn


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 32000
    dim: int = 512
    enc_layers: int = 6
    dec_layers: int = 6
    num_heads: int = 8
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    attention: str = "dense"     # self-attention: 'dense' | 'flash'

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def _block_config(self, causal: bool) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1, dim=self.dim, num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio, max_seq_len=self.max_seq_len,
            dropout=self.dropout, dtype=self.dtype,
            attention=self.attention, causal=causal)


class CrossAttention(nn.Module):
    """Decoder queries attend over the encoder memory (no mask). Under
    tensor parallelism the layer holds its rank's heads (`q` and `kv`
    split by column, `out` by row): the decoder stream and the memory
    enter through `copy_to_tensor`, the output leaves through one
    all-reduce."""

    def __init__(self, cfg: Seq2SeqConfig, generator: torch.Generator,
                 device: torch.device, mesh: tp.Optional[Mesh] = None):
        super().__init__()
        self.config = cfg
        self.mesh = mesh
        h, dh = cfg.num_heads, cfg.head_dim
        self.q = _Kernel((cfg.dim, h, dh), cfg.dim, generator, device)
        self.kv = _Kernel((cfg.dim, 2, h, dh), cfg.dim, generator, device)
        self.out = _Kernel((h, dh, cfg.dim), h * dh, generator, device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = cfg.dtype
        mesh = layer_mesh(self.mesh, self.q.kernel.shape[1], cfg.num_heads,
                          "cross-attention heads")
        q = torch.einsum("btd,dhk->bthk", copy_to_tensor(x.to(dtype), mesh),
                         self.q.kernel.to(dtype))
        kv = torch.einsum("bsd,dchk->bschk",
                          copy_to_tensor(memory.to(dtype), mesh),
                          self.kv.kernel.to(dtype))
        out = dot_product_attention(q, kv[:, :, 0], kv[:, :, 1],
                                    causal=False)
        return reduce_from_tensor(torch.einsum(
            "bthk,hkD->btD", out, self.out.kernel.to(dtype)), mesh)


class DecoderBlock(nn.Module):
    """Causal self-attention + cross-attention + MLP, pre-RMSNorm. `index`
    is its layer in the whole model, which seeds its dropout sites."""

    def __init__(self, cfg: Seq2SeqConfig, generator: torch.Generator,
                 device: torch.device, index: int = 0,
                 mesh: tp.Optional[Mesh] = None):
        super().__init__()
        self.config = cfg
        self.index = index
        bcfg = cfg._block_config(causal=True)
        self.norm1 = RMSNorm(cfg.dim, cfg.dtype, device)
        self.attn = Attention(bcfg, generator, device, mesh)
        self.norm2 = RMSNorm(cfg.dim, cfg.dtype, device)
        self.xattn = CrossAttention(cfg, generator, device, mesh)
        self.norm3 = RMSNorm(cfg.dim, cfg.dtype, device)
        self.mlp = MLPBlock(bcfg, generator, device, mesh)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                positions: torch.Tensor,
                dropout_seed: tp.Optional[DropoutSeed] = None
                ) -> torch.Tensor:
        rate = self.config.dropout

        def site(number: int) -> tp.Optional[DropoutSeed]:
            return None if dropout_seed is None else fold_dropout_seed(
                dropout_seed, self.index, number)

        x = x + dropout(self.attn(self.norm1(x), positions), rate,
                        site(DROPOUT_MIXER))
        x = x + dropout(self.xattn(self.norm2(x), memory), rate,
                        site(DROPOUT_CROSS))
        return x + dropout(self.mlp(self.norm3(x)), rate, site(DROPOUT_MLP))


class Seq2SeqTransformer(nn.Module):
    """(src [B, S], tgt [B, T]) int -> f32 logits [B, T, vocab].

    Teacher-forced training forward: the caller feeds BOS + tgt[:-1] and
    predicts tgt. `encode` and `decode` run alone, so generation computes
    the memory once. `train=True` with `dropout > 0` drops (sites seeded
    by layer: encoder blocks 0..enc_layers-1, decoder blocks after them)
    and needs a `dropout_seed`.

    Args:
        config: the model configuration.
        device: where the parameters live; `cuda` unless asked otherwise.
        seed: seeds the random init.
        mesh: the mesh whose 'tensor' axis `parallel.wrap` cuts the model
            over (`seq2seq_shardings`): the layers then run on their
            slices, the embedding vocab-parallel and the head giving the
            rank's [B, T, V/T] logits.
    """

    def __init__(self, config: Seq2SeqConfig, *, device: tp.Any = None,
                 seed: int = 0, mesh: tp.Optional[Mesh] = None):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self.config = config
        self.mesh = mesh
        self.embed = _param((config.vocab_size, config.dim), 0.02,
                            generator, device)
        enc_cfg = config._block_config(causal=False)
        for i in range(config.enc_layers):
            setattr(self, f"enc_blocks_{i}", Block(enc_cfg, generator,
                                                   device, mesh=mesh,
                                                   index=i))
        self.enc_norm = RMSNorm(config.dim, config.dtype, device)
        for i in range(config.dec_layers):
            setattr(self, f"dec_blocks_{i}", DecoderBlock(
                config, generator, device, index=config.enc_layers + i,
                mesh=mesh))
        self.dec_norm = RMSNorm(config.dim, config.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _vocab_mesh(self) -> tp.Optional[Mesh]:
        return layer_mesh(self.mesh, self.embed.shape[0],
                          self.config.vocab_size, "vocabulary rows")

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        mesh = self._vocab_mesh()
        if mesh is None:
            return self.embed[tokens.long()].to(self.config.dtype)
        return vocab_parallel_embedding(tokens, self.embed, mesh
                                        ).to(self.config.dtype)

    def shardings(self) -> tp.Dict[str, tp.Any]:
        """`seq2seq_shardings` of the model's parameters: the layout
        `parallel.wrap` cuts it by."""
        return seq2seq_shardings(dict(self.named_parameters()))

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.shape[1] > self.config.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds "
                f"max_seq_len={self.config.max_seq_len}")
        return torch.arange(tokens.shape[1], device=tokens.device).expand(
            tokens.shape)

    def encode(self, src: torch.Tensor, train: bool = False,
               dropout_seed: tp.Optional[DropoutSeed] = None
               ) -> torch.Tensor:
        seed = training_dropout_seed(self.config.dropout, train,
                                     dropout_seed)
        positions = self._positions(src)
        x = self._embed(src)
        for i in range(self.config.enc_layers):
            x = getattr(self, f"enc_blocks_{i}")(x, positions, None, seed)
        return self.enc_norm(x)

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor,
               train: bool = False,
               dropout_seed: tp.Optional[DropoutSeed] = None
               ) -> torch.Tensor:
        seed = training_dropout_seed(self.config.dropout, train,
                                     dropout_seed)
        positions = self._positions(tgt)
        y = self._embed(tgt)
        for i in range(self.config.dec_layers):
            y = getattr(self, f"dec_blocks_{i}")(y, memory, positions, seed)
        y = self.dec_norm(y)
        # the tied head in f32, as the JAX package computes it (the rank's
        # vocabulary columns under tensor parallelism)
        y = copy_to_tensor(y, self._vocab_mesh())
        return torch.einsum("btd,vd->btv", y.float(), self.embed.float())

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                train: bool = False,
                dropout_seed: tp.Optional[DropoutSeed] = None
                ) -> torch.Tensor:
        return self.decode(tgt, self.encode(src, train, dropout_seed), train,
                           dropout_seed)


def seq2seq_shardings(params: tp.Any) -> tp.Dict[str, tp.Any]:
    """The spec of every parameter of a Seq2SeqTransformer, by name (the
    port of the JAX package's `seq2seq_shardings`): the block rules of
    `transformer_shardings` (the shared block names match; `mlp/up`
    carries `pairs=2`), extended with the cross attention's projections:
    q [D, H, Dh] and the fused kv [D, 2, H, Dh] split by column, out
    [H, Dh, D] by row (`attn/out`'s rule). Each spec is cut to its
    leaf's rank, as the reference cuts it."""
    from ..parallel.sharding import P
    from .transformer import transformer_spec

    def spec_for(name: str, leaf: tp.Any) -> P:
        joined = name.replace(".", "/")
        if "xattn/q" in joined:
            spec = P("fsdp", "tensor", None)
        elif "xattn/kv" in joined:
            spec = P("fsdp", None, "tensor", None)
        else:
            spec = transformer_spec(joined)
        if "embed" in joined:
            return spec
        return P(*spec[:len(np.shape(leaf))], pairs=spec.pairs)

    return {name: spec_for(name, leaf) for name, leaf in params.items()}


Params = tp.Dict[str, tp.Any]


def _decode_tree(model: Seq2SeqTransformer) -> Params:
    """The model's weights as the JAX tree's nested dict, detached, with
    the matmul kernels cast to the compute dtype (the cast at use of the
    JAX step); norm scales and the embedding stay f32."""
    dtype = model.config.dtype
    tree: Params = {}
    for name, param in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = param.detach().to(dtype) if leaf == "kernel" \
            else param.detach()
    return tree


def _precompute_cross_kv(cfg: Seq2SeqConfig, p: Params,
                         memory: torch.Tensor
                         ) -> tp.List[tp.Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder block's cross K/V, computed once a generation: they
    depend on the encoder memory only."""
    out = []
    for i in range(cfg.dec_layers):
        kernel = p[f"dec_blocks_{i}"]["xattn"]["kv"]["kernel"]
        kv = torch.einsum("bsd,dchk->bschk", memory.to(cfg.dtype),
                          kernel.to(cfg.dtype))
        out.append((kv[:, :, 0], kv[:, :, 1]))
    return out


def init_decode_cache(cfg: Seq2SeqConfig, batch: int, max_len: int,
                      device: tp.Any = None) -> tp.Dict:
    """Self-attention K/V caches of the decoder blocks, zeros."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.num_heads, cfg.head_dim)
    return {f"dec_blocks_{i}": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        for i in range(cfg.dec_layers)}


def _dec_step(cfg: Seq2SeqConfig, p: Params, tokens: torch.Tensor,
              positions: torch.Tensor, cache: tp.Dict, cache_index: int,
              cross_kv: tp.Sequence[tp.Tuple[torch.Tensor, torch.Tensor]]):
    """The decoder over `tokens` [B, S] against the caches, written in
    place: `decode`'s arithmetic with the self-attention read from the
    cache and the cross K/V precomputed. Returns (logits, cache)."""
    from .decoding import _cached_self_attention, _gated_mlp
    x = p["embed"][tokens.long()].to(cfg.dtype)
    scale = score_scale(cfg.head_dim)
    for i in range(cfg.dec_layers):
        name = f"dec_blocks_{i}"
        bp = p[name]
        x, _, _ = _cached_self_attention(cfg, bp, x, positions,
                                         cache[name]["k"], cache[name]["v"],
                                         cache_index)
        # cross attention against the precomputed memory K/V
        normed = rmsnorm(x, bp["norm2"]["scale"], cfg.dtype)
        qx = torch.einsum("btd,dhk->bthk", normed,
                          bp["xattn"]["q"]["kernel"])
        kx, vx = cross_kv[i]
        scores = torch.einsum("bqhd,bkhd->bhqk", qx.float(),
                              kx.float()) * scale
        probs = torch.softmax(scores, dim=-1)
        xa = torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype), vx)
        x = x + torch.einsum("bqhd,hdD->bqD", xa,
                             bp["xattn"]["out"]["kernel"])
        x = x + _gated_mlp(bp["mlp"],
                           rmsnorm(x, bp["norm3"]["scale"], cfg.dtype),
                           cfg.dtype)
    x = rmsnorm(x, p["dec_norm"]["scale"], cfg.dtype)
    logits = torch.einsum("btd,vd->btv", x.float(), p["embed"].float())
    return logits, cache


def _source(model: Seq2SeqTransformer, src: tp.Any) -> torch.Tensor:
    return torch.as_tensor(np.asarray(src) if not torch.is_tensor(src)
                           else src, device=model.device).long()


def cached_translate(model: Seq2SeqTransformer, src: tp.Any, *,
                     max_new_tokens: int, bos_id: int = 1) -> torch.Tensor:
    """Greedy decode with KV caches: [B, max_new_tokens] tokens, O(T) a
    step. The encoder runs once, the cross K/V are precomputed, and each
    step runs the decoder on one token against the cached prefix; the
    argmax chain of `greedy_translate`."""
    cfg = model.config
    if max_new_tokens + 1 > cfg.max_seq_len:
        raise ValueError(f"max_new_tokens + 1 = {max_new_tokens + 1} "
                         f"exceeds max_seq_len={cfg.max_seq_len}")
    src = _source(model, src)
    batch = src.shape[0]
    with torch.no_grad():
        memory = model.encode(src)
        p = _decode_tree(model)
        cross_kv = _precompute_cross_kv(cfg, p, memory)
        cache = init_decode_cache(cfg, batch, max_new_tokens + 1,
                                  device=src.device)
        token = torch.full((batch, 1), bos_id, dtype=torch.long,
                           device=src.device)
        out = []
        for t in range(max_new_tokens):
            positions = torch.full((batch, 1), t, dtype=torch.long,
                                   device=src.device)
            logits, cache = _dec_step(cfg, p, token, positions, cache, t,
                                      cross_kv)
            token = logits[:, -1].argmax(dim=-1)[:, None]
            out.append(token)
    return torch.cat(out, dim=1)


def greedy_translate(model: Seq2SeqTransformer, src: tp.Any, *,
                     max_new_tokens: int, bos_id: int = 1) -> torch.Tensor:
    """Greedy decode: [B, max_new_tokens] tokens. The memory is computed
    once; every step re-runs the decoder over the whole buffer (causal
    masking keeps the not yet written positions inert). Exact, O(T^2):
    the oracle of `cached_translate`."""
    src = _source(model, src)
    batch = src.shape[0]
    with torch.no_grad():
        memory = model.encode(src)
        buf = torch.full((batch, max_new_tokens + 1), bos_id,
                         dtype=torch.long, device=src.device)
        for t in range(max_new_tokens):
            logits = model.decode(buf, memory)
            buf[:, t + 1] = logits[:, t].argmax(dim=-1)
    return buf[:, 1:]
