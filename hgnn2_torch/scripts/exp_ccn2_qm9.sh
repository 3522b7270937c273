#!/bin/bash
# CCN-2D on QM9, L=2, h=2, every vertex of a batch at once: the port's
# twin of scripts/exp_ccn2_qm9.sh.
set -e
cd "$(dirname "$0")/../.."
python -m hgnn2_torch.cli.main_ccn_qm9 --k 2 \
  --L 2 --h 2 --bs ${BS:-256} --epochs ${EPOCHS:-20} \
  --optim adamax --lr 1e-3 --task ${TASK:-0} "$@"
