#!/bin/bash
# the final chip call: the final tree unpacked from its git archive into
# _chipwork/tree: the smoke and the CUDA tests, then the smoke alone in
# an empty directory
cd "$(dirname "$0")/../.."
out=chiprun_out/pr15
mkdir -p $out
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
(cd _chipwork/tree && python3 chip_smoke.py) > $out/final_chip_smoke.log 2>&1
echo smoke_rc=$? wall_s=$(( $(date +%s) - t0 ))
(cd _chipwork/tree && python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py) > $out/final_cuda_tests.log 2>&1
echo tests_rc=$?
alone=$(mktemp -d) && cp _chipwork/tree/chip_smoke.py "$alone"/
(cd "$alone" && python3 chip_smoke.py) > $out/final_alone.log 2>&1
echo alone_rc=$?
rm -rf "$alone"
tail -3 $out/final_alone.log
tail -2 $out/final_cuda_tests.log
grep -E "^smoke:|decode:|decodes:|decode without|parity:|FAIL|fps|phase 1[345]|ctu|children|---|mesh|ctb 64" $out/final_chip_smoke.log | cut -c1-300 | tail -70
tail -3 $out/final_chip_smoke.log
