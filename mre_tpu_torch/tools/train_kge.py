"""KGE training runner over the OpenKE façade, with the reference example
recipes (the port's counterpart of examples/train_kge.py).

One runner covers the 13 reference example scripts
(OpenKE/examples/train_*.py); each recipe keeps its upstream
hyperparameters.

    python -m mre_tpu_torch.tools.train_kge --recipe transe_FB15K237 \\
        --in_path /path/to/benchmarks/FB15K237/ [--train_times N] [--dim D] \\
        [--type_constrain] [--checkpoint PATH] [--device cuda|cpu]

Without --in_path a synthetic benchmark is written to a temporary directory
(the reference's benchmark files are not redistributed with this repo).
Training and evaluation run on --device (default cuda; no card raises).
"""

from __future__ import annotations

import argparse
import inspect
import sys
import tempfile
import time

RECIPES = {
    # name: (model, model_kwargs, loader_kwargs, strategy_kwargs, trainer_kwargs)
    "transe_FB15K237": ("TransE", dict(dim=200, p_norm=1, norm_flag=True),
                        dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                        dict(loss=("margin", dict(margin=5.0))),
                        dict(train_times=1000, alpha=1.0, opt_method="sgd")),
    "transe_WN18_adv_sigmoidloss": ("TransE", dict(dim=1024, p_norm=1, norm_flag=False, margin=6.0),
                                    dict(batch_size=2000, bern_flag=0, filter_flag=1,
                                         neg_ent=64, sampling_mode="cross"),
                                    dict(loss=("sigmoid", dict(adv_temperature=1.0))),
                                    dict(train_times=3000, alpha=2e-5, opt_method="adam")),
    "transh_FB15K237": ("TransH", dict(dim=200, p_norm=1, norm_flag=True),
                        dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                        dict(loss=("margin", dict(margin=4.0))),
                        dict(train_times=1000, alpha=0.5, opt_method="sgd")),
    "transr_FB15K237": ("TransR", dict(dim_e=200, dim_r=200, p_norm=1, norm_flag=True, rand_init=False),
                        dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                        dict(loss=("margin", dict(margin=4.0))),
                        dict(train_times=1000, alpha=1.0, opt_method="sgd")),
    "transd_FB15K237": ("TransD", dict(dim_e=200, dim_r=200, p_norm=1, norm_flag=True),
                        dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                        dict(loss=("margin", dict(margin=4.0))),
                        dict(train_times=1000, alpha=1.0, opt_method="sgd")),
    "rescal_FB15K237": ("RESCAL", dict(dim=50),
                        dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                        dict(loss=("margin", dict(margin=1.0))),
                        dict(train_times=1000, alpha=0.1, opt_method="adagrad")),
    "distmult_WN18RR": ("DistMult", dict(dim=200),
                        dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                        dict(loss=("softplus", dict()), regul_rate=1.0),
                        dict(train_times=2000, alpha=0.5, opt_method="adagrad")),
    "distmult_WN18RR_adv": ("DistMult", dict(dim=1024, margin=200.0, epsilon=2.0),
                            dict(batch_size=2000, bern_flag=0, filter_flag=1,
                                 neg_ent=64, sampling_mode="cross"),
                            dict(loss=("sigmoid", dict(adv_temperature=0.5)),
                                 l3_regul_rate=0.000005),
                            dict(train_times=400, alpha=0.002, opt_method="adam")),
    "complex_WN18RR": ("ComplEx", dict(dim=200),
                       dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                       dict(loss=("softplus", dict()), regul_rate=1.0),
                       dict(train_times=2000, alpha=0.5, opt_method="adagrad")),
    "analogy_WN18RR": ("Analogy", dict(dim=200),
                       dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                       dict(loss=("softplus", dict()), regul_rate=1.0),
                       dict(train_times=2000, alpha=0.5, opt_method="adagrad")),
    "simple_WN18RR": ("SimplE", dict(dim=200),
                      dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                      dict(loss=("softplus", dict()), regul_rate=1.0),
                      dict(train_times=2000, alpha=0.5, opt_method="adagrad")),
    "hole_WN18RR": ("HolE", dict(dim=100),
                    dict(nbatches=100, bern_flag=1, filter_flag=1, neg_ent=25),
                    dict(loss=("softplus", dict()), regul_rate=1.0),
                    dict(train_times=1000, alpha=0.5, opt_method="adagrad")),
    "rotate_WN18RR_adv": ("RotatE", dict(dim=1024, margin=6.0, epsilon=2.0),
                          dict(batch_size=2000, bern_flag=0, filter_flag=1,
                               neg_ent=64, sampling_mode="cross"),
                          dict(loss=("sigmoid", dict(adv_temperature=2.0))),
                          dict(train_times=6000, alpha=2e-5, opt_method="adam")),
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    parser.add_argument("--in_path", default="")
    parser.add_argument("--train_times", type=int, default=None)
    parser.add_argument("--dim", type=int, default=None)
    parser.add_argument("--type_constrain", action="store_true")
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def run(args, in_path: str) -> dict:
    """Train ``args.recipe`` on the benchmark at ``in_path`` and evaluate it.
    Returns the metrics (MRR, MR, Hits@10, Hits@3, Hits@1), the model, the
    trainer (epoch losses and the sample / step seconds) and the seconds of
    the ranking pass."""
    from mre_tpu_torch import openke as ok

    model_name, model_kw, loader_kw, strat_kw, train_kw = RECIPES[args.recipe]
    model_kw, loader_kw = dict(model_kw), dict(loader_kw)
    strat_kw, train_kw = dict(strat_kw), dict(train_kw)
    if args.dim:
        for k in ("dim", "dim_e", "dim_r"):
            if k in model_kw:
                model_kw[k] = args.dim
    if args.train_times:
        train_kw["train_times"] = args.train_times

    loader = ok.TrainDataLoader(in_path=in_path, threads=8, **loader_kw)
    model_cls = getattr(ok, model_name)
    # exactly the constructor args this class takes (margin / epsilon reach
    # the init-range branch of the models that have one upstream)
    accepted = inspect.signature(model_cls.__init__).parameters
    model = model_cls(loader.get_ent_tot(), loader.get_rel_tot(),
                      **{k: v for k, v in model_kw.items() if k in accepted})

    loss_name, loss_kw = strat_kw.pop("loss")
    loss = {"margin": ok.MarginLoss, "sigmoid": ok.SigmoidLoss,
            "softplus": ok.SoftplusLoss}[loss_name](**loss_kw)
    strategy = ok.NegativeSampling(model=model, loss=loss,
                                   batch_size=loader.get_batch_size(), **strat_kw)
    trainer = ok.Trainer(model=strategy, data_loader=loader, log_every=50,
                         device=args.device, **train_kw)
    trainer.run()
    if args.checkpoint:
        model.save_checkpoint(args.checkpoint)

    tester = ok.Tester(model=model, data_loader=ok.TestDataLoader(in_path=in_path),
                       device=args.device)
    t0 = time.perf_counter()
    metrics = tester.run_link_prediction(type_constrain=args.type_constrain)
    return dict(metrics=metrics, model=model, trainer=trainer,
                rank_s=time.perf_counter() - t0)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.in_path:
        return run(args, args.in_path)
    from mre_tpu_torch.data.fixtures import write_openke_benchmark

    with tempfile.TemporaryDirectory() as tmp:
        in_path = tmp + "/"
        write_openke_benchmark(in_path, n_ent=200, n_rel=12, n_train=2000,
                               n_valid=200, n_test=200)
        print(f"[train_kge] no --in_path given; synthetic benchmark at {in_path}",
              file=sys.stderr)
        return run(args, in_path)


if __name__ == "__main__":
    main()
