#!/bin/bash
# chip call 2, four cards: the multi-device dryrun over the four CUDA
# devices (MeshTiledIntraPipeline: one host thread and one batched call
# of 4 tiles a card a frame) against the tile-by-tile encode on cuda:0
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr15
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python -m kvazaar_tpu_torch.parallel.dryrun 4 > chiprun_out/pr15/call2_dryrun4.log 2>&1
echo dryrun_rc=$? wall_s=$(( $(date +%s) - t0 ))
tail -20 chiprun_out/pr15/call2_dryrun4.log
