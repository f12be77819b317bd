#!/bin/bash
# The dry-run sweep, `dryrun --mesh both --technique` and `hillclimb
# --exp all` run as one process a cell or an experiment, 7 at a time:
# the model cells on the CPU, the technique cells on the card. The cells
# and experiments are the ones the CLIs list. Records, logs and the
# sweep table (table.md) go to the directory given (default
# results/dryrun_sweep).
#
#     bash dryrun_sweep.sh [OUT]
set -u
export PYTHONPATH=src
OUT=${1:-results/dryrun_sweep}
mkdir -p $OUT/logs
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $OUT/smi.txt
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)"
nproc; free -g | head -2
exps=$(python -m repro_torch.launch.hillclimb --list)
cells=$(python -m repro_torch.launch.dryrun --technique --list)
{
    # the longest first: llama4's experiments, then the technique cells
    for e in $exps; do
        case $e in llama4*) echo "timeout 1800 python -m repro_torch.launch.hillclimb --exp $e --out $OUT/hillclimb_torch > $OUT/logs/hc_$e.log 2>&1";; esac
    done
    for c in $cells; do
        case $c in greedyml*) echo "timeout 900 python -m repro_torch.launch.dryrun --technique --only $c --mesh both --out $OUT/dryrun_torch > $OUT/logs/${c%%:*}.log 2>&1";; esac
    done
    for e in $exps; do
        case $e in llama4*) ;; *) echo "timeout 1800 python -m repro_torch.launch.hillclimb --exp $e --out $OUT/hillclimb_torch > $OUT/logs/hc_$e.log 2>&1";; esac
    done
    for c in $cells; do
        case $c in greedyml*) ;; *) for m in single multi; do
            echo "timeout 1500 python -m repro_torch.launch.dryrun --only $c --mesh $m --out $OUT/dryrun_torch > $OUT/logs/${c/:/__}__$m.log 2>&1"
        done;; esac
    done
} > $OUT/jobs.txt
wc -l $OUT/jobs.txt
start=$(date +%s)
tr '\n' '\0' < $OUT/jobs.txt | xargs -0 -P 7 -I{} sh -c '{}'
echo "sweep seconds $(( $(date +%s) - start ))"
grep -h "^\[OK\]\|^\[FAIL\]" $OUT/logs/*.log | sort
grep -h "dominant\|done in\|FAILED" $OUT/logs/hc_*.log
python -m repro_torch.launch.hillclimb --table $OUT/dryrun_torch | tee $OUT/table.md
