"""Stage-1 adversarial similarity learner (port of
``bridged_gnn_tpu/nn/stage1.py``; reference models/models.py).

  * :class:`SAGEConv` and :class:`GraphEncoder`: the SAGE stack of the
    ``gnn`` backbone; its mean aggregation is the padded SpMM kernel
    (``ops/spmm.py`` → ``csrc/gather_reduce.cu``). The stage-2 GraphSAGE
    backbone uses the conv too.
  * :class:`SimilarV2`: the similarity head, ``"cosine"`` (lin_self +
    biasatt residual, cosine, sigmoid) or ``"mlp"`` (BN → Linear(2H, 128)
    → BN → ReLU → Linear(128, 1) over concatenated pairs), with the node
    classifier; :class:`SimilarNoTrans` and :class:`SimNet`.
  * :class:`SourceLearnerV2` (backbone + head), :class:`TargetLearnerAEV2`
    (equivalence translation, encoder, decoder) and
    :class:`AdversarialLearnerV2` with the discriminator, the inference
    calls of evaluation and bridge building, and ``train_forward``.

Module names are the JAX package's, which follow the reference
``state_dict`` (``lin_self_0``, ``biasatt_2``,
``equavilent_trans_layer_0``, ``convs.0`` for flax's ``convs_0``), so
``io/flax_weights.py`` carries weights across by name.

Train or eval mode is the module's own (``model.train()`` /
``model.eval()``): batch norms take batch statistics and dropout runs in
train mode. Dropout draws from the ``generator`` a forward is given; its
rates are the JAX package's constants (class attributes ``dropout_p`` and
``SourceLearnerV2.clf_dropout_p``), which no config or flag sets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bridged_gnn_tpu_torch.nn.common import (
    Decoder,
    Discriminator,
    MaskedBatchNorm,
    MLPBackbone,
    TorchLinear,
    _ACTIVATIONS,
    _layer_dims,
    dropout,
    pair_norm,
)
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, spmm

Tensor = torch.Tensor


def rows(table: Tensor, idx: Tensor) -> Tensor:
    """``table[idx]``: the rows of an ``[N, D]`` table at int64 ids, as an
    embedding lookup, whose backward sums each row's cotangents in a fixed
    order. Advanced indexing's backward adds them with atomics on the CPU,
    so two runs of one seed could part in the last bit there."""
    return F.embedding(idx, table)


def cosine_similarity(a: Tensor, b: Tensor, eps: float = 1e-8) -> Tensor:
    """``torch.nn.CosineSimilarity(dim=1)`` as the JAX package computes
    it: each norm clamped at ``eps`` apart."""
    na = torch.linalg.norm(a, dim=-1).clamp(min=eps)
    nb = torch.linalg.norm(b, dim=-1).clamp(min=eps)
    return (a * b).sum(-1) / (na * nb)


class SAGEConv(nn.Module):
    """GraphSAGE conv: ``lin_l(mean-aggregate(x)) [+ lin_r(x)]`` (PyG
    SAGEConv defaults: mean aggregation, bias on ``lin_l`` only; JAX
    ``nn/stage1.py:47-65``). The aggregation is the padded SpMM
    kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 root_weight: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = TorchLinear(in_channels, out_channels,
                                 generator=generator)
        self.lin_r = (TorchLinear(in_channels, out_channels, bias=False,
                                  generator=generator)
                      if root_weight else None)

    def forward(self, x: Tensor, adj: Adjacency, shard=None) -> Tensor:
        """``shard``: a ``parallel.gspmd.RowShard`` when ``x`` holds a
        rank's rows and ``adj`` the edges into them: the senders' rows are
        all-gathered first, and the SpMM's transposed pass writes every
        sender row, which the gather's backward sums over the ranks."""
        x_all = x if shard is None else shard.gather_all(x)
        out = self.lin_l(spmm(adj, x_all, reduce="mean"))
        if self.lin_r is not None:
            out = out + self.lin_r(x)
        return out


class GraphEncoder(nn.Module):
    """SAGE stack with PairNorm → ReLU → dropout (0.5) between layers
    (reference models/models.py:220-263; JAX ``nn/stage1.py:68-97``)."""

    dropout_p = 0.5

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int = 64,
                 layer_num: int = 2, root_weight: bool = True,
                 norm_mode: str = "PN-SCS", norm_scale: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = _layer_dims(dim_out, dim_hidden, layer_num)
        self.convs = nn.ModuleList(
            SAGEConv(a, b, root_weight, generator=generator)
            for a, b in zip([dim_in] + dims[:-1], dims))
        self.norm_mode = norm_mode
        self.norm_scale = norm_scale

    def forward(self, x: Tensor, adj: Adjacency,
                mask: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard=None) -> Tensor:
        """``shard``: as :meth:`MLPBackbone.forward`'s, and the convs
        gather their senders' rows."""
        group = None
        if shard is not None:
            mask, group = shard.node_mask, shard.group
        for i, conv in enumerate(self.convs):
            x = conv(x, adj, shard)
            if i < len(self.convs) - 1:
                x = pair_norm(x, mask, self.norm_mode, self.norm_scale,
                              group)
                x = torch.relu(x)
                if self.training:
                    x = (dropout(x, self.dropout_p, generator)
                         if shard is None
                         else shard.dropout(x, self.dropout_p, generator))
        return x


class SimilarV2(nn.Module):
    """The similarity head (reference models/models.py:895-997; JAX
    ``nn/stage1.py:100-193``)."""

    def __init__(self, in_channels: int, num_clf_classes: int,
                 dropout: float = 0.6, use_clf: bool = True,
                 mode: str = "mlp", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mode = mode
        self.dropout_p = dropout
        g = generator
        if mode == "cosine":
            self.lin_self_0 = MaskedBatchNorm(in_channels)
            self.lin_self_1 = TorchLinear(in_channels, 64, bias=False,
                                          generator=g)
            self.lin_self_2 = MaskedBatchNorm(64)
            self.lin_self_4 = TorchLinear(64, 128, bias=False, generator=g)
            self.biasatt_0 = TorchLinear(128, 64, generator=g)
            self.biasatt_2 = TorchLinear(64, 128, generator=g)
        elif mode == "mlp":
            self.lin_self_0 = MaskedBatchNorm(2 * in_channels)
            self.lin_self_1 = TorchLinear(2 * in_channels, 128, generator=g)
            self.lin_self_2 = MaskedBatchNorm(128)
            self.lin_self_4 = TorchLinear(128, 1, generator=g)
        else:
            raise ValueError(f"unsupported mode: {mode}")
        self.lin_clf = (TorchLinear(in_channels, num_clf_classes,
                                    generator=g) if use_clf else None)

    @property
    def use_clf(self) -> bool:
        return self.lin_clf is not None

    def embed_cosine(self, x: Tensor) -> Tensor:
        """lin_self of cosine mode: BN → Linear → BN → tanh → Linear."""
        z = self.lin_self_1(self.lin_self_0(x))
        return self.lin_self_4(torch.tanh(self.lin_self_2(z)))

    def biasatt(self, z: Tensor) -> Tensor:
        """The biasatt residual: ``z + biasatt_2(tanh(biasatt_0(z)))``."""
        return z + self.biasatt_2(torch.tanh(self.biasatt_0(z)))

    def pair_mlp(self, x_pair: Tensor) -> Tensor:
        """lin_self of mlp mode: BN → Linear → BN → ReLU → Linear."""
        z = self.lin_self_1(self.lin_self_0(x_pair))
        return self.lin_self_4(torch.relu(self.lin_self_2(z)))

    def similarity(self, x: Tensor, idx1: Tensor, idx2: Tensor) -> Tensor:
        if self.mode == "cosine":
            z = self.embed_cosine(x)
            alpha = cosine_similarity(self.biasatt(rows(z, idx1)),
                                      self.biasatt(rows(z, idx2)))
        else:
            alpha = self.pair_mlp(torch.cat([rows(x, idx1), rows(x, idx2)],
                                            1))[:, 0]
        return torch.sigmoid(alpha)

    def similarity_cross_domain(self, x_src: Tensor, x_tar: Tensor,
                                idx1: Tensor, idx2: Tensor) -> Tensor:
        if self.mode == "cosine":
            z1 = rows(self.embed_cosine(x_src), idx1)
            z2 = rows(self.embed_cosine(x_tar), idx2)
            alpha = cosine_similarity(self.biasatt(z1), self.biasatt(z2))
        else:
            alpha = self.pair_mlp(
                torch.cat([rows(x_src, idx1), rows(x_tar, idx2)], 1))[:, 0]
        return torch.sigmoid(alpha)

    def classify(self, z: Tensor,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Log-softmax classifier over node embeddings
        (models.py:993-995)."""
        h = torch.relu(z)
        if self.training:
            h = dropout(h, self.dropout_p, generator)
        return torch.log_softmax(self.lin_clf(h), dim=-1)

    def forward(self, x: Tensor, idx1: Tensor, idx2: Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Optional[Tensor]]:
        log_probs_clf = self.classify(x, generator) if self.use_clf else None
        return self.similarity(x, idx1, idx2)[:, None], log_probs_clf


class SimilarNoTrans(nn.Module):
    """Raw-feature cosine similarity head (reference models.py:171-217;
    JAX ``nn/stage1.py:196-226``): the sigmoid of the inputs' cosine,
    and the optional classifier."""

    def __init__(self, in_channels: int, num_clf_classes: int,
                 dropout: float = 0.6, use_clf: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_p = dropout
        self.lin_clf = (TorchLinear(in_channels, num_clf_classes,
                                    generator=generator)
                        if use_clf else None)

    def similarity(self, x: Tensor, idx1: Tensor, idx2: Tensor) -> Tensor:
        return torch.sigmoid(cosine_similarity(rows(x, idx1), rows(x, idx2)))

    def similarity_cross_domain(self, x_src: Tensor, x_tar: Tensor,
                                idx1: Tensor, idx2: Tensor) -> Tensor:
        return torch.sigmoid(cosine_similarity(rows(x_src, idx1),
                                               rows(x_tar, idx2)))

    def forward(self, x: Tensor, idx1: Tensor, idx2: Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Optional[Tensor]]:
        log_probs_clf = None
        if self.lin_clf is not None:
            h = torch.relu(x)
            if self.training:
                h = dropout(h, self.dropout_p, generator)
            log_probs_clf = torch.log_softmax(self.lin_clf(h), dim=-1)
        return self.similarity(x, idx1, idx2)[:, None], log_probs_clf


class SimNet(nn.Module):
    """Generic pair-MLP scorer (reference models.py:520-574; JAX
    ``nn/stage1.py:229-257``): Linear(2H → H) [+ BN] + activation,
    ``num_layer - 1`` times, then Linear(H → 1) → sigmoid. JAX's
    ``dropout`` field is unused there and not taken here."""

    def __init__(self, dim_in: int, dim_hidden: int, num_layer: int = 2,
                 use_bn: bool = False, act_fn: str = "relu", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [dim_hidden] * (num_layer - 1) + [1]
        self.layers = nn.ModuleList(
            TorchLinear(a, b, generator=generator)
            for a, b in zip([2 * dim_in] + widths[:-1], widths))
        self.bns = (nn.ModuleList(MaskedBatchNorm(dim_hidden)
                                  for _ in range(num_layer - 1))
                    if use_bn else None)
        self.act = _ACTIVATIONS[act_fn]

    def forward(self, z: Tensor, idx1: Tensor, idx2: Tensor) -> Tensor:
        x = torch.cat([rows(z, idx1), rows(z, idx2)], 1)
        for i, lin in enumerate(self.layers[:-1]):
            x = lin(x)
            if self.bns is not None:
                x = self.bns[i](x)
            x = self.act(x)
        return torch.sigmoid(self.layers[-1](x))


def _backbone(kind: str, dim_in: int, dim_hidden: int, num_layer: int,
              use_norm: bool, norm_mode: str, norm_scale: float,
              generator) -> nn.Module:
    if kind == "mlp":
        return MLPBackbone(dim_in, dim_hidden, dim_hidden=dim_hidden,
                           layer_num=num_layer, use_norm=use_norm,
                           norm_mode=norm_mode, norm_scale=norm_scale,
                           generator=generator)
    if kind == "gnn":
        return GraphEncoder(dim_in, dim_hidden, dim_hidden=dim_hidden,
                            layer_num=num_layer, norm_mode=norm_mode,
                            norm_scale=norm_scale, generator=generator)
    raise ValueError(kind)


class SourceLearnerV2(nn.Module):
    """Backbone + similarity head over the source graph (reference
    models/models.py:999-1052; JAX ``nn/stage1.py:260-318``)."""

    clf_dropout_p = 0.6

    def __init__(self, dim_in: int, num_classes: int, dim_hidden: int = 64,
                 use_clf: bool = True, use_norm: bool = True,
                 backbone: str = "mlp", sim_mode: str = "cosine",
                 norm_mode: str = "None", norm_scale: float = 1.0,
                 num_layer: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = backbone
        self.backbone_net = _backbone(backbone, dim_in, dim_hidden,
                                      num_layer, use_norm, norm_mode,
                                      norm_scale, generator)
        self.sim_net = SimilarV2(dim_hidden, num_classes,
                                 dropout=self.clf_dropout_p, use_clf=use_clf,
                                 mode=sim_mode, generator=generator)

    def encode(self, x: Tensor, adj: Optional[Adjacency],
               mask: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None,
               shard=None) -> Tensor:
        """The embeddings of ``x``'s rows; with ``shard`` (a rank's rows,
        ``parallel/gspmd.py``) all-gathered into the whole table."""
        if self.backbone == "mlp":
            h = self.backbone_net(x, mask, generator, shard)
        else:
            h = self.backbone_net(x, adj, mask, generator, shard)
        return h if shard is None else shard.gather(h)

    def forward(self, x, adj, idx1, idx2, mask=None, generator=None,
                shard=None):
        h = self.encode(x, adj, mask, generator, shard)
        probs_pair, log_probs_clf = self.sim_net(h, idx1, idx2, generator)
        return probs_pair, log_probs_clf, h


class TargetLearnerAEV2(nn.Module):
    """Equivalence translation + encoder + decoder autoencoder over the
    target graph (reference models/models.py:1055-1107; JAX
    ``nn/stage1.py:321-380``)."""

    def __init__(self, dim_in: int, dim_eq_trans: int = 128,
                 dim_hidden: int = 64, use_norm: bool = True,
                 backbone: str = "mlp", norm_mode: str = "None",
                 norm_scale: float = 1.0, num_layer: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = backbone
        self.norm_mode = norm_mode
        self.norm_scale = norm_scale
        self.equavilent_trans_layer_0 = TorchLinear(
            dim_in, dim_eq_trans, generator=generator)
        self.encoder = _backbone(backbone, dim_eq_trans, dim_hidden,
                                 num_layer, use_norm, norm_mode, norm_scale,
                                 generator)
        self.decoder = Decoder(dim_hidden, dim_hidden, dim_eq_trans,
                               num_layer=2, use_norm=True,
                               norm_mode=norm_mode, norm_scale=norm_scale,
                               generator=generator)

    def encode(self, x: Tensor, adj: Optional[Adjacency] = None,
               mask: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None, shard=None
               ) -> Tuple[Tensor, Tensor]:
        """``(z, h0)`` of ``x``'s rows; with ``shard`` (a rank's rows,
        ``parallel/gspmd.py``) both all-gathered into whole tables."""
        group = None
        if shard is not None:
            mask, group = shard.node_mask, shard.group
        h0 = pair_norm(self.equavilent_trans_layer_0(x), mask,
                       self.norm_mode, self.norm_scale, group)
        h0 = torch.tanh(h0)
        if self.backbone == "mlp":
            z = self.encoder(h0, mask, generator, shard)
        else:
            z = self.encoder(h0, adj, mask, generator, shard)
        if shard is not None:
            z, h0 = shard.gather(z), shard.gather(h0)
        return z, h0

    def decode(self, z: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        return torch.tanh(self.decoder(z, mask))

    def forward(self, x, adj=None, mask=None, generator=None, shard=None):
        z, h0 = self.encode(x, adj, mask, generator, shard)
        return h0, z, self.decode(z, mask)


class AdversarialLearnerV2(nn.Module):
    """The stage-1 model (reference models/models.py:1110-1142; JAX
    ``nn/stage1.py:383-507``): source learner, target autoencoder and
    domain discriminator."""

    def __init__(self, dim_in_src: int, dim_in_tar: int,
                 num_classes_src: int, num_classes_tar: int,
                 dim_hidden: int = 64, source_clf: bool = True,
                 use_norm: bool = True, norm_mode: str = "None",
                 norm_scale: float = 1.0, backbone: str = "mlp",
                 sim_mode: str = "cosine", num_layer: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.source_clf = source_clf
        self.sim_mode = sim_mode
        self.source_learner = SourceLearnerV2(
            dim_in_src, num_classes_src, dim_hidden=dim_hidden,
            use_clf=source_clf, use_norm=use_norm, backbone=backbone,
            sim_mode=sim_mode, norm_mode=norm_mode, norm_scale=norm_scale,
            num_layer=num_layer, generator=generator)
        self.target_learner = TargetLearnerAEV2(
            dim_in_tar, dim_eq_trans=128, dim_hidden=dim_hidden,
            use_norm=use_norm, backbone=backbone, norm_mode=norm_mode,
            norm_scale=norm_scale, num_layer=num_layer, generator=generator)
        self.discriminator = Discriminator(
            dim_hidden, dim_hidden, num_layer=2, act_fn="relu",
            sigmoid_output=True, generator=generator)

    # --- inference calls of evaluation and bridge building

    def get_probs_within_domain(self, x, adj, idx1, idx2,
                                domain: str = "target", mask=None,
                                generator=None):
        if domain == "source":
            probs_pair, log_probs_clf, _ = self.source_learner(
                x, adj, idx1, idx2, mask, generator)
        else:
            z, _ = self.target_learner.encode(x, adj, mask, generator)
            probs_pair, log_probs_clf = self.source_learner.sim_net(
                z, idx1, idx2, generator)
        probs_clf = (torch.exp(log_probs_clf)
                     if log_probs_clf is not None else None)
        return probs_pair, probs_clf

    def get_probs_cross_domain(self, x_src, adj_src, x_tar, adj_tar, idx1,
                               idx2, mask_src=None, mask_tar=None,
                               generator=None):
        z_src, z_tar = self.encode_domains(x_src, adj_src, x_tar, adj_tar,
                                           mask_src, mask_tar, generator)
        sim = self.source_learner.sim_net
        probs_pair = sim.similarity_cross_domain(z_src, z_tar, idx1,
                                                 idx2)[:, None]
        if self.source_clf:
            probs_clf_src = torch.exp(sim.classify(z_src, generator))
            probs_clf_tar = torch.exp(sim.classify(z_tar, generator))
        else:
            probs_clf_src = probs_clf_tar = None
        return probs_pair, probs_clf_src, probs_clf_tar, z_src, z_tar

    def encode_domains(self, x_src, adj_src, x_tar, adj_tar, mask_src=None,
                       mask_tar=None, generator=None, shard_src=None,
                       shard_tar=None):
        """Embeddings of both domains (the bridge build's front end);
        with shards, of every rank's rows from this rank's
        (``parallel/gspmd.py``)."""
        z_src = self.source_learner.encode(x_src, adj_src, mask_src,
                                           generator, shard_src)
        z_tar, _ = self.target_learner.encode(x_tar, adj_tar, mask_tar,
                                              generator, shard_tar)
        return z_src, z_tar

    def discriminate(self, z: Tensor) -> Tensor:
        return self.discriminator(z)

    def train_forward(self, x_src, adj_src, x_tar, adj_tar, idx1_src,
                      idx2_src, idx1_tar, idx2_tar, idx1_cross, idx2_cross,
                      mask_src=None, mask_tar=None, generator=None,
                      shard_src=None, shard_tar=None) -> dict:
        """One stage-1 forward in the reference's call order (scripts.py:
        34-54; JAX ``train_forward``): source pairs, the target
        autoencoder, target pairs scored by the source head, cross pairs,
        the discriminator on the target, so the batch norms' running
        statistics see the same sequence of updates. With shards
        (``parallel/gspmd.py``) ``x_*`` and ``adj_*`` are this rank's rows
        and the edges into them, ``mask_*`` the whole graphs' masks: the
        encoders run on the rank's rows and everything after them on the
        gathered tables, alike on every rank."""
        probs_pair_src, log_clf_src, h_src = self.source_learner(
            x_src, adj_src, idx1_src, idx2_src, mask_src, generator,
            shard_src)
        h0_tar, h_tar, recons = self.target_learner(
            x_tar, adj_tar, mask_tar, generator, shard_tar)
        sim = self.source_learner.sim_net
        probs_pair_tar, log_clf_tar = sim(h_tar, idx1_tar, idx2_tar,
                                          generator)
        probs_pair_cross = sim.similarity_cross_domain(
            h_src, h_tar, idx1_cross, idx2_cross)[:, None]
        d_tar = self.discriminator(h_tar)
        return dict(
            probs_pair_src=probs_pair_src, probs_pair_tar=probs_pair_tar,
            probs_pair_cross=probs_pair_cross, log_clf_src=log_clf_src,
            log_clf_tar=log_clf_tar, h_src=h_src, h_tar=h_tar,
            h0_tar=h0_tar, recons=recons, d_tar=d_tar,
        )
