"""One typed configuration tree for the whole two-stage pipeline.

Port of ``bridged_gnn_tpu/config.py``: ``BridgeConfig``,
``PipelineConfig`` (JSON out and in) and ``RECIPES``, built on the
port's ``Stage1Config`` and ``Stage2Config``, whose fields are the JAX
package's. A ``PipelineConfig`` JSON either package writes, the other
reads, and every recipe is the JAX package's field for field under the
same name (the reference's ``run.sh`` recipes and the production one,
``office_amazon2dslr_tpu``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from bridged_gnn_tpu_torch.train.stage1 import Stage1Config
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config


@dataclasses.dataclass
class BridgeConfig:
    """The bridge build's settings (reference main_bridged_graph.py
    flags)."""

    k_cross: int = 20
    k_within: int = 6
    check_cross: bool = False
    check_within: bool = False
    thres_conf_quantile: float = 0.1
    thres_feat_sim: float = 0.8
    epsilon: float = 0.5          # accepted and unused, as the reference's
    row_block: int = 512
    # None: exact top-k. A float in (0, 1]: JAX's approx_max_k recall
    # target, which selects exactly off the TPU, as the port does
    approx_recall: Optional[float] = None
    # mlp head: screen columns with the bf16 cosine of the embeddings,
    # then the exact head at the top N candidates of each row; None = off
    rerank_candidates: Optional[int] = None


@dataclasses.dataclass
class PipelineConfig:
    dataset_name: str = "sync_unrelational"
    data_root: str = "../datasets"
    stage1: Stage1Config = dataclasses.field(default_factory=Stage1Config)
    bridge: BridgeConfig = dataclasses.field(default_factory=BridgeConfig)
    stage2: Stage2Config = dataclasses.field(default_factory=Stage2Config)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        raw = json.loads(text)
        return cls(
            dataset_name=raw.get("dataset_name", cls.dataset_name),
            data_root=raw.get("data_root", cls.data_root),
            stage1=Stage1Config(**raw.get("stage1", {})),
            bridge=BridgeConfig(**raw.get("bridge", {})),
            stage2=Stage2Config(**raw.get("stage2", {})),
        )

    @classmethod
    def from_file(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            return cls.from_json(f.read())


# The JAX package's recipes (its config.py:71-145; reference run.sh:1-31)
RECIPES: Dict[str, PipelineConfig] = {
    # the a2d recipe with the production settings: scan mode in both
    # stages, pairs drawn on the device, the approx_max_k selector and
    # the mlp head's rerank, bf16 messages and "default" matmul precision
    "office_amazon2dslr_tpu": PipelineConfig(
        dataset_name="office_amazon2dslr",
        stage1=Stage1Config(hidden_dim=128, num_epoch=400,
                            start_eval_epoch=300, sim_mode="mlp",
                            backbone="mlp", seed=0, scan_epochs=25,
                            device_sampling=True),
        bridge=BridgeConfig(k_within=3, k_cross=20, check_within=True,
                            check_cross=True, approx_recall=0.95,
                            rerank_candidates=256),
        stage2=Stage2Config(num_layer=2, hidden=64, to_undirected=True,
                            scan_epochs=50, matmul_precision="default",
                            message_dtype="bfloat16"),
    ),
    "office_amazon2dslr": PipelineConfig(
        dataset_name="office_amazon2dslr",
        stage1=Stage1Config(hidden_dim=128, num_epoch=400,
                            start_eval_epoch=300, sim_mode="mlp",
                            backbone="mlp", seed=0),
        bridge=BridgeConfig(k_within=3, k_cross=20, check_within=True,
                            check_cross=True),
        stage2=Stage2Config(num_layer=2, hidden=64, to_undirected=True),
    ),
    "office_amazon2webcam": PipelineConfig(
        dataset_name="office_amazon2webcam",
        stage1=Stage1Config(hidden_dim=128, num_epoch=400,
                            start_eval_epoch=300, seed=0),
        bridge=BridgeConfig(k_within=3, k_cross=8, check_within=True,
                            check_cross=True),
        stage2=Stage2Config(num_layer=2, hidden=128, to_undirected=True),
    ),
    "twitter_unrelational": PipelineConfig(
        dataset_name="twitter_unrelational",
        stage1=Stage1Config(num_epoch=400, start_eval_epoch=300, seed=0),
        bridge=BridgeConfig(k_within=6, k_cross=20, check_within=True),
        stage2=Stage2Config(num_layer=2, hidden=128, to_undirected=True),
    ),
    "fb_hamilton2caltech": PipelineConfig(
        dataset_name="fb_hamilton2caltech",
        stage1=Stage1Config(hidden_dim=64, num_epoch=400,
                            start_eval_epoch=300, seed=0),
        bridge=BridgeConfig(k_within=0, k_cross=50, check_within=True,
                            check_cross=True, thres_feat_sim=0.0),
        stage2=Stage2Config(num_epoch=300, num_layer=2, hidden=64,
                            to_undirected=True, no_dtc=True,
                            model_name="GraphSAGE", use_scheduler=False),
    ),
    "fb_howard2simmons": PipelineConfig(
        dataset_name="fb_howard2simmons",
        stage1=Stage1Config(hidden_dim=64, num_epoch=400,
                            start_eval_epoch=300, eval_per_epoch=5, seed=0),
        bridge=BridgeConfig(k_within=0, k_cross=50, check_within=True,
                            check_cross=True, thres_feat_sim=0.0),
        stage2=Stage2Config(num_epoch=200, num_layer=2, hidden=64),
    ),
    "sync_unrelational": PipelineConfig(
        dataset_name="sync_unrelational",
        stage1=Stage1Config(num_epoch=100, start_eval_epoch=80,
                            eval_per_epoch=5, seed=0),
        bridge=BridgeConfig(k_within=3, k_cross=10),
        stage2=Stage2Config(num_layer=2, hidden=64, to_undirected=True),
    ),
}
