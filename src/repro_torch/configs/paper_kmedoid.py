"""Paper experiment config: k-medoid exemplar clustering (Tiny-ImageNet
regime), answers `src/repro/configs/paper_kmedoid.py`.

`CONFIG` is the reference's laptop-sized copy. `TINY_IMAGENET` keeps its
tree (k = 200 exemplars, m = 32 leaves, b = 2, so L = 5) at the shape of
the dataset the docstring names: Tiny-ImageNet's 100,000 training images
of 64×64×3 = 12,288 features, drawn from the `gen_images` mixture recipe
(synthetic, made from the seed; nothing is downloaded). Reckoned on one
H100: features 4.9 GB, padded leaf pools ≈ 5 GB, leaf caches
32 × ≈3,200² × 4 B ≈ 1.3 GB, level-1 node matrices 16 × 400² × 4 B =
10 MB.
"""
from repro_torch.configs.base import SubmodularConfig

CONFIG = SubmodularConfig(
    objective="kmedoid",
    k=200,
    n=8_192,
    feature_dim=768,
    num_machines=32,
    branching=2,
    seed=13,
    augment=0,
)

TINY_IMAGENET = SubmodularConfig(
    objective="kmedoid",
    k=200,
    n=100_000,
    feature_dim=64 * 64 * 3,
    num_machines=32,
    branching=2,
    seed=13,
    augment=0,
)
