#!/bin/bash
# CCN-1D on QM9, L=20, h=2: the port's twin of scripts/exp_ccn1_qm9.sh.
set -e
cd "$(dirname "$0")/../.."
python -m hgnn2_torch.cli.main_ccn_qm9 --k 1 \
  --L 20 --h 2 --bs ${BS:-256} --epochs ${EPOCHS:-20} \
  --optim adamax --lr 1e-3 --task ${TASK:-0} "$@"
