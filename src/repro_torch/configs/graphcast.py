"""graphcast: encoder-processor-decoder mesh GNN, 16L d512, sum aggregator.

[arXiv:2212.12794] n_vars=227 / mesh_refinement=6 are the weather-mesh
parameters; the four graph shapes supply their own feature and target
widths, so the config is made per cell (d_in/d_out from the ShapeCell).
"""
from repro_torch.configs.base import GNN_SHAPES, ArchSpec, ShapeCell
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.optim import OptimConfig


def make_config(cell: ShapeCell = None, **kw) -> GNNConfig:
    base = dict(
        name="graphcast", n_layers=16, d_hidden=512,
        d_in=cell.d_feat if cell else 227, d_out=cell.d_out if cell else 227,
        mesh_refinement=6, aggregator="sum",
    )
    base.update(kw)  # overrides (n_layers, precision, ...)
    return GNNConfig(**base)


def make_reduced() -> GNNConfig:
    return GNNConfig(name="graphcast-smoke", n_layers=2, d_hidden=32,
                     d_in=16, d_out=4)


SPEC = ArchSpec(
    arch_id="graphcast", family="gnn", source="arXiv:2212.12794",
    make_config=make_config, make_reduced=make_reduced, shapes=GNN_SHAPES,
    optim=OptimConfig(kind="adamw", lr=1e-3),
)
