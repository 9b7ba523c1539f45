"""Entry point: python -m lvdgs_torch --config configs/mono/synthetic/base_config.yaml

Loads the layered YAML config, builds the dataset, Gaussian map and SLAM
system on the chosen device (CUDA by default), runs the SLAM loop, then
colour refinement and the final evaluation.
"""
import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="LVD-GS SLAM (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--n-frames", type=int, default=None,
                        help="limit the number of processed frames")
    parser.add_argument("--save-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs the plain kernels)")
    parser.add_argument("--no-color-refinement", action="store_true")
    parser.add_argument("--no-eval-rendering", action="store_true")
    args = parser.parse_args(argv)

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.core.log import Log
    from lvdgs_torch.slam.system import SLAM

    config = load_config(args.config)
    save_dir = args.save_dir
    if save_dir is None:
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        save_dir = os.path.join(config.get("Results", {}).get("save_dir", "results"), stamp)
    os.makedirs(save_dir, exist_ok=True)

    slam = SLAM(config, save_dir=save_dir, device=args.device)
    if args.no_color_refinement:
        slam.do_color_refinement = False
    if args.no_eval_rendering:
        slam.do_eval_rendering = False
    results = slam.run(n_frames=args.n_frames)
    Log(f"Results: {results}", tag="Eval")
    return results


if __name__ == "__main__":
    main()
