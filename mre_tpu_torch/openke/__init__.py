"""OpenKE-compatible toolkit surface (port of mre_tpu/openke).

Usage mirrors the reference examples (OpenKE/examples/train_transe_FB15K237.py):

    from mre_tpu_torch.openke import TrainDataLoader, TestDataLoader, TransE, \
        NegativeSampling, MarginLoss, Trainer, Tester

    loader = TrainDataLoader(in_path=..., nbatches=100, bern_flag=1,
                             filter_flag=1, neg_ent=25)
    model = TransE(loader.get_ent_tot(), loader.get_rel_tot(), dim=200)
    strategy = NegativeSampling(model=model, loss=MarginLoss(margin=5.0),
                                batch_size=loader.get_batch_size())
    Trainer(model=strategy, data_loader=loader, train_times=1000, alpha=1.0).run()
    Tester(model=model, data_loader=TestDataLoader(in_path=...)).run_link_prediction()

Trainer and Tester run on ``cuda`` unless given ``device="cpu"``.
"""

from mre_tpu_torch.openke.data import TrainDataLoader, TestDataLoader, read_benchmark, read_type_constraints
from mre_tpu_torch.openke.module import (
    Analogy, ComplEx, DistMult, HolE, MarginLoss, Model, NegativeSampling,
    RESCAL, RotatE, SigmoidLoss, SimplE, SoftplusLoss, TransD, TransE, TransH, TransR,
)
from mre_tpu_torch.openke.config import Tester, Trainer
