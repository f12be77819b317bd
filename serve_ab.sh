#!/bin/bash
# Model serving on one card, one tree against another: `launch/serve.py`
# at chip_smoke.py's serve shapes (batch 4, prompt 512, 32 tokens, one
# warm-up round, bf16 weights drawn from seed 0) for each arch, run as
# parent, change, change, parent (a process each), every run's prefill and
# decode line prefixed with its arch and tree. ARCH:L cuts the depth to L.
#
#     bash serve_ab.sh PARENT_DIR [ARCH[:L] ...]
set -eu
PARENT=$1
shift
ARCHS=${*:-mamba2-1.3b qwen3-moe-30b-a3b:4 qwen2.5-3b}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in $ARCHS; do
    arch=${spec%%:*}
    layers=0
    [[ $spec == *:* ]] && layers=${spec#*:}
    for tree in parent change change parent; do
        dir=.
        [ $tree = parent ] && dir=$PARENT
        line=$(cd "$dir" && PYTHONPATH=src python -m repro_torch.launch.serve \
            --arch "$arch" --layers "$layers" --prompt-len 512 --gen 32 \
            --batch 4 --warmup 1 | grep "^prefill")
        echo "$arch $tree $line"
    done
done
