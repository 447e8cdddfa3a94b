#!/bin/bash
# Produce a reference-style results pack from a trained model on synthetic
# patches, with the PyTorch port on the card: the twin of the JAX package's
# tools/demo_results_pack.sh, the same twelve evaluate calls with the same
# flags through python -m s1s2_torch.cli.evaluate (which runs on the card).
# Usage: s1s2_torch/tools/demo_results_pack.sh PATCH_DIR CKPT OUT_ROOT [PRED_PARAM]
set -e
P=$1; CKPT=$2; OUT=$3; PARAM=${4:-v}
COMMON="--patch_dir $P --ckpt $CKPT --T 1000 --base_ch 96 --pred_param $PARAM --batch_size 16"

python -m s1s2_torch.cli.evaluate --mode onestep $COMMON --out_dir $OUT/Onestep --t_small 20
python -m s1s2_torch.cli.evaluate --mode ddim $COMMON --out_dir $OUT/DDIM_Multi-step \
    --t_start 200 --ddim_steps 20 --max_files 48 --full_metrics
python -m s1s2_torch.cli.evaluate --mode ddim_sweep $COMMON --out_dir $OUT/DDIM_Sweep \
    --t_start_grid 300,200,150,100 --ddim_steps_grid 10,20 --max_files 32
python -m s1s2_torch.cli.evaluate --mode vdiag $COMMON --out_dir $OUT/VDiag \
    --t_small 20 --max_files 32
python -m s1s2_torch.cli.evaluate --mode seed_stats $COMMON --out_dir $OUT/Seed_Stats \
    --t_small 20 --n_seeds 4 --max_files 16
python -m s1s2_torch.cli.evaluate --mode per_band $COMMON --out_dir $OUT/Per_Band \
    --t_small 20 --max_files 32
python -m s1s2_torch.cli.evaluate --mode ablate $COMMON --out_dir $OUT/Ablate \
    --t_small 20 --max_files 16
python -m s1s2_torch.cli.evaluate --mode true_infer $COMMON --out_dir $OUT/Pure_Generation \
    --t_start 999 --ddim_steps 50 --n_seeds 2 --max_files 10
python -m s1s2_torch.cli.evaluate --mode limitation $COMMON --out_dir $OUT/Limitation_Test \
    --ddim_steps 50 --eta 0.05 --max_files 16 --save_n 2 --viz_mode dataset_fixed
python -m s1s2_torch.cli.evaluate --mode baseline_bicubic --patch_dir $P \
    --out_dir $OUT/Baselines --batch_size 16 --max_files 32
python -m s1s2_torch.cli.evaluate --mode baseline_linear --patch_dir $P \
    --out_dir $OUT/Baselines --batch_size 16 --max_files 32
echo "RESULTS PACK DONE: $OUT"

# round-2: int8 quantized variant of the headline ddim mode
python -m s1s2_torch.cli.evaluate --mode ddim $COMMON --out_dir $OUT/DDIM_int8 \
    --t_start 200 --ddim_steps 20 --max_files 48 --full_metrics --int8
