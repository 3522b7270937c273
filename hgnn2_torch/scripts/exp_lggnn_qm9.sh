#!/bin/bash
# The line-graph GNN (GNNLineGraph) on QM9, L=5, h=1, update order 2: the
# port's twin of scripts/exp_lggnn_qm9.sh.
set -e
cd "$(dirname "$0")/../.."
python -m hgnn2_torch.cli.main_gnn_qm9 --lg --update 2 \
  --L 5 --h 1 --J 1 --bs ${BS:-512} --epochs ${EPOCHS:-20} \
  --optim adamax --lr 3e-4 --lrdamping 0.9 --step 5 --task ${TASK:-0} "$@"
