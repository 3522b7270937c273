#!/bin/bash
# CCN on the collinear-points classification set: the port's twin of
# scripts/exp_ccn_col.sh.
set -e
cd "$(dirname "$0")/../.."
python -m hgnn2_torch.cli.main_generate_ccn \
  --k ${K:-1} --n ${N:-1000} --Nmax 20 --L 2 --h 12 --bs ${BS:-64} \
  --epochs ${EPOCHS:-20} --optim adamax --lr 1e-2 "$@"
