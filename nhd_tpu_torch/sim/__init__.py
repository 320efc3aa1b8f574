from nhd_tpu_torch.sim.synth import (
    SynthNodeSpec,
    make_cluster,
    make_node,
    make_node_labels,
    make_triad_config,
)

__all__ = [
    "SynthNodeSpec",
    "make_cluster",
    "make_node",
    "make_node_labels",
    "make_triad_config",
]
