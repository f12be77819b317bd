"""Paper experiment config: k-vertex-dominating set (road/Friendster
regime), answers `src/repro/configs/paper_kdom.py`.

Synthetic road-like graph (low avg degree ≈ 2.4, like
road_usa/road_central; `data/synthetic.py::gen_graph_road`), its closed
neighbourhoods packed as bitmaps over the vertices. Reckoned on one
H100: 65,536 × 2,048 words × 4 B = 537 MB of bitmaps; a leaf holds
≈8,192 candidates over 2,048 words (streaming), a level-1 node batch
4 × 256 × 2,048 × 4 B = 8 MB (resident).
"""
from repro_torch.configs.base import SubmodularConfig

CONFIG = SubmodularConfig(
    objective="kdom",
    k=128,
    n=65_536,
    universe=65_536,             # ground set == universe (vertices)
    num_machines=8,
    branching=2,
    seed=11,
)
