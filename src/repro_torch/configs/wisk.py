"""The paper's own serving shape: the flat fallback step's widths
(launch/flat_legacy.py), as the JAX package's ``configs/wisk.py``."""
import dataclasses


@dataclasses.dataclass
class WiskServeConfig:
    name: str = "wisk"
    n_queries: int = 4096       # global query batch
    n_nodes: int = 65536        # index nodes at the filtered level
    vocab: int = 4096           # keyword vocabulary (bitmap words = vocab/32)
    candidate_cap: int = 4096   # per-query verification capacity
    levels: int = 3


def config() -> WiskServeConfig:
    return WiskServeConfig()
