"""lm1b-style word language model with sampled softmax.

Counterpart of ``autodist_tpu/models/lm1b.py``: an embedding
(``embedding``), a stack of LSTMs (``lstm_i``), a projection (``proj``)
back to the embedding width, and a sampled softmax over a separate
output table (``softmax_w``, ``softmax_b``), both tables declared sparse.

The LSTM parameters are flax ``OptimizedLSTMCell`` leaves: input kernels
``lstm_i/{ii,if,ig,io}/kernel [in, H]`` without bias and recurrent
``lstm_i/{hi,hf,hg,ho}/{kernel [H, H], bias}``; the forward stacks them
into torch's ``i, f, g, o`` layout (``b_ih`` zero) and runs
``torch._VF.lstm`` (cuDNN on the card) from a zero carry.

The negatives are shared across the batch and drawn with TF's
log-uniform (Zipfian) sampler from :func:`~autodist_tpu_torch.ops
.threefry.uniform` on the key of the step's seed, so the same key gives
the same ``neg_ids`` bit for bit as ``jax.random.uniform`` does in the
JAX package; in a captured window the seed is read from the
``GraphSeed``'s buffer.  fp32, as the JAX model computes.
"""
from __future__ import annotations

import torch
from torch import nn

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.models.embedding import SparseEmbed
from autodist_tpu_torch.models.layers import (Dense, functional_tensors,
                                              init_params, module_params)
from autodist_tpu_torch.models.losses import cross_entropy_from_logits
from autodist_tpu_torch.models.transformer import normal
from autodist_tpu_torch.ops import threefry
from autodist_tpu_torch.ops.sparse import embedding_lookup

GATES = "ifgo"          # flax's and torch's gate order


def _log_vocab(vocab_size: int, device):
    """``log(V + 1)`` in fp32 on ``device``, made there (no host copy,
    so a captured graph may hold it)."""
    return torch.full((), vocab_size + 1.0, device=device).log()


def log_uniform_sample(key, num_samples: int, vocab_size: int):
    """Log-uniform (Zipfian) candidate ids ``[num_samples]`` int32 and
    their expected-count probabilities, from a threefry ``key``."""
    u = threefry.uniform(key, 0.0, 1.0, num=num_samples)
    log_v = _log_vocab(vocab_size, u.device)
    ids = (torch.exp(u * log_v) - 1.0).to(torch.int32)
    ids = torch.clamp(ids, 0, vocab_size - 1)
    probs = torch.log1p(1.0 / (ids.float() + 1.0)) / log_v
    return ids, probs


def sampled_softmax_loss(key, weights, biases, hidden, labels,
                         num_samples: int, vocab_size: int):
    """Sampled-softmax cross entropy of ``labels [B]`` under ``hidden
    [B, H]`` against ``weights [V, H]`` and ``biases [V]``, the
    negatives drawn from ``key`` and shared across the batch (TF's
    behaviour), each logit corrected by its log expected count and an
    accidental hit of the true label masked."""
    neg_ids, neg_q = log_uniform_sample(key, num_samples, vocab_size)
    true_w = embedding_lookup(weights, labels)            # [B, H]
    neg_w = embedding_lookup(weights, neg_ids)            # [S, H]
    true_logit = (hidden * true_w).sum(-1) + biases[labels.long()]
    neg_logit = hidden @ neg_w.T + biases[neg_ids.long()][None]
    log_v = _log_vocab(vocab_size, hidden.device)
    true_q = torch.log1p(1.0 / (labels.float() + 1.0)) / log_v
    true_logit = true_logit - torch.log(torch.clamp(true_q, min=1e-20))
    neg_logit = neg_logit - torch.log(torch.clamp(neg_q, min=1e-20))[None]
    hit = neg_ids[None, :] == labels[:, None]
    neg_logit = torch.where(hit, torch.finfo(torch.float32).min, neg_logit)
    logits = torch.cat([true_logit[:, None], neg_logit], dim=1)
    zeros = torch.zeros(logits.shape[0], dtype=torch.long,
                        device=logits.device)
    return cross_entropy_from_logits(logits, zeros).mean()


class _Recurrent(Dense):
    """An ``h*`` gate of flax's ``OptimizedLSTMCell``: kernel drawn
    orthogonal (flax's ``recurrent_kernel_init``), zero bias."""

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        nn.init.orthogonal_(self.kernel.data, generator=generator)


class OptimizedLSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``'s parameters; :meth:`weights` gives
    torch's ``[w_ih, w_hh, b_ih, b_hh]`` of them."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in GATES:
            self.add_module(f"i{g}", Dense(in_features, features,
                                           use_bias=False))
        for g in GATES:
            self.add_module(f"h{g}", _Recurrent(features, features))

    def weights(self) -> list:
        hs = [getattr(self, f"h{g}") for g in GATES]
        w_ih = torch.cat([getattr(self, f"i{g}").kernel.T for g in GATES])
        w_hh = torch.cat([h.kernel.T for h in hs])
        b_hh = torch.cat([h.bias for h in hs])
        return [w_ih, w_hh, torch.zeros_like(b_hh), b_hh]


class LSTMWordLM(nn.Module):
    """Embedding, stacked LSTM, projection (a definition):
    ``forward(tokens [B, L])`` gives ``[B, L, embed_dim]``."""

    def __init__(self, vocab_size: int = 800_000, embed_dim: int = 512,
                 hidden_dim: int = 1024, num_layers: int = 2):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.embedding = SparseEmbed(vocab_size, embed_dim)
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", OptimizedLSTMCell(
                embed_dim if i == 0 else hidden_dim, hidden_dim))
        self.proj = Dense(hidden_dim, embed_dim)

    def forward(self, tokens):
        x = self.embedding(tokens)
        flat = [w for i in range(self.num_layers)
                for w in getattr(self, f"lstm_{i}").weights()]
        carry = x.new_zeros(self.num_layers, x.shape[0], self.hidden_dim)
        out, _, _ = torch._VF.lstm(x, (carry, carry), flat, True,
                                   self.num_layers, 0.0, True, False, True)
        return self.proj(out)


def make_lm1b_trainable(optimizer, generator, *, vocab_size=10_000,
                        embed_dim=128, hidden_dim=256, num_layers=1,
                        seq_len=20, batch_size=8, num_samples=64,
                        device=None):
    """A Trainable for :class:`LSTMWordLM` with the sampled softmax on
    ``{"x": [B, L], "y": [B, L]}``, its parameters drawn from
    ``generator`` and placed on ``device`` (``None``: the card).  The
    output table ``softmax_w`` is drawn N(0, 0.05²) from a generator
    seeded 17, as the JAX package draws it from ``PRNGKey(17)`` whatever
    the init key; ``softmax_b`` is zero.  Each step's negatives come
    from the key of its seed."""
    del seq_len, batch_size
    model = init_params(LSTMWordLM(vocab_size, embed_dim, hidden_dim,
                                   num_layers), generator, device)
    params = module_params(model)
    dev = model.proj.kernel.device
    fixed = torch.Generator(device=generator.device).manual_seed(17)
    params["softmax_w"] = (normal((vocab_size, embed_dim), 0.05, fixed)
                           .to(dev))
    params["softmax_b"] = torch.zeros(vocab_size, device=dev)

    def loss(p, extra, batch, rng):
        p = dict(p)
        sw, sb = p.pop("softmax_w"), p.pop("softmax_b")
        hidden = torch.func.functional_call(model, functional_tensors(p),
                                            (batch["x"],))
        hidden = hidden.reshape(-1, hidden.shape[-1])
        labels = batch["y"].reshape(-1)
        seed = cuda_graph.seed_tensor(rng, hidden.device)
        if seed is None:
            raise ValueError("the sampled softmax draws its negatives from "
                             "the step's seed; got rng=None")
        l = sampled_softmax_loss(threefry.key(seed), sw, sb, hidden, labels,
                                 num_samples, vocab_size)
        return l, extra, {"loss": l}

    return Trainable(loss, params, optimizer,
                     sparse_params=("embedding/embedding", "softmax_w"))
