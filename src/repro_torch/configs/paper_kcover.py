"""Paper experiment config: maximum k-set-cover (webdocs/kosarak/retail
regime), answers `src/repro/configs/paper_kcover.py`.

`CONFIG` is the reference's laptop-sized copy. `KOSARAK` is the shape of
the FIMI repository's kosarak click-stream dataset, which the
reference's docstring names: 990,002 transactions over 41,270 items, a
mean of 8.1 distinct items each. The data is synthetic, made from the
seed with the reference's `gen_kcover` recipe at `KOSARAK_AVG_SIZE`
(its duplicate draws collapse under np.unique: 15.0 gives a mean of 8.02
distinct items over 100,000 sets and 8.08 over 200,000, seed 7); nothing
is downloaded.

m = 32 leaves, not the reference config's 8: at m = 8 a leaf holds
123,750 candidates, whose (C,) mask (495 KB) exceeds a block's 227 KB,
so the planner sends the leaves to the fused engine and the streaming
loop's bitmap kernel would run nowhere. m = 32 (the k-medoid
configuration's tree, L = 5) gives ≈30,938 candidates a leaf, which
stream.

Reckoned on one H100: W = ⌈41,270/32⌉ = 1,290 words a set; the bitmaps
take 990,002 × 1,290 × 4 B = 5.1 GB as the port's 32-bit words, and the
padded leaf pools as much again; a level-1 node is 128 candidates ×
1,290 words × 4 B = 660 KB, and its 16 nodes' 10.6 MB fit the 25 MB L2
share, so the nodes run resident.
"""
from repro_torch.configs.base import SubmodularConfig

CONFIG = SubmodularConfig(
    objective="kcover",
    k=64,
    n=65_536,
    universe=16_384,
    num_machines=8,
    branching=2,
    seed=7,
)

KOSARAK = SubmodularConfig(
    objective="kcover",
    k=64,
    n=990_002,
    universe=41_270,
    num_machines=32,
    branching=2,
    seed=7,
)

# gen_kcover's avg_size for a mean of ≈8.1 distinct items per set
KOSARAK_AVG_SIZE = 15.0
