#!/bin/bash
# The power GNN (GNNSimple) on QM9, L=15, h=1, 20 epochs, Adamax lr 3e-4:
# the port's twin of scripts/exp_gnn_qm9.sh. Runs on the card; add
# --device cpu for the CPU, --data_path for a QM9 cache.
set -e
cd "$(dirname "$0")/../.."
python -m hgnn2_torch.cli.main_gnn_qm9 \
  --L 15 --h 1 --J 1 --bs ${BS:-1024} --epochs ${EPOCHS:-20} \
  --optim adamax --lr 3e-4 --lrdamping 0.9 --step 5 --task ${TASK:-0} "$@"
