#!/bin/bash
# The power GNN on the collinear-points classification set: the port's
# twin of scripts/exp_gnn_col.sh.
set -e
cd "$(dirname "$0")/../.."
python -m hgnn2_torch.cli.main_generate \
  --n ${N:-1000} --Nmax 50 --L 4 --h 4 --bs ${BS:-64} --epochs ${EPOCHS:-20} \
  --optim adamax --lr 3e-3 "$@"
