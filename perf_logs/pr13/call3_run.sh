#!/bin/bash
# chip call 3, four cards: the multi-device dryrun over the four CUDA
# devices (MeshTiledIntraPipeline, one host thread a card) against the
# tile-by-tile encode on cuda:0
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr13
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python -m kvazaar_tpu_torch.parallel.dryrun 4 > chiprun_out/pr13/call3_dryrun4.log 2>&1
echo dryrun_rc=$? wall_s=$(( $(date +%s) - t0 ))
cat chiprun_out/pr13/call3_dryrun4.log | tail -20
