#!/bin/bash
# one chip call: the main path's wall time, parent (_chipwork/parent, the
# parent commit's git archive) against this tree, in the order parent,
# change, change, parent
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr11
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in _chipwork/parent _chipwork/tree _chipwork/tree _chipwork/parent; do
  python3 perf_logs/pr11/ab_main.py $t 2>&1 | grep -v Warning
done | tee chiprun_out/pr11/call3_ab_main.log
