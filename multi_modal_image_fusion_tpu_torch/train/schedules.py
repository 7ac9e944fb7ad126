"""LR schedule of the reference trainer (counterpart of
multi_modal_image_fusion_tpu train/schedules.py):

- MultiStepLR at (2/3 E, 8/9 E) epochs, gamma 0.1 (reference train.py:148,
  320)
- optional iteration-level warmup over the first epoch with factor 0.001
  and method 'linear' or 'constant' (reference common.py:136-166,
  train.py:321-324, 78-79)

One function of the update step (counted from 0). It is plain Python on the
host, so it is its own host twin: the JAX package's `schedule.host`.
"""


def make_lr_schedule(base_lr, steps_per_epoch, num_epochs,
                     milestones=None, gamma=0.1,
                     warmup=False, warmup_factor=0.001,
                     warmup_iters=None, warmup_method="linear"):
    if milestones is None:
        milestones = (round(num_epochs * 2 / 3), round(num_epochs * 8 / 9))
    milestone_steps = [m * steps_per_epoch for m in milestones]
    if warmup_iters is None:
        warmup_iters = steps_per_epoch
    if warmup_method not in ("constant", "linear"):
        raise ValueError("only supported ['constant', 'linear'] method")

    def schedule(step):
        lr = base_lr * gamma ** sum(step >= s for s in milestone_steps)
        if warmup and step < warmup_iters:
            if warmup_method == "constant":
                # reference common.py:160-161: flat warmup_factor until
                # warmup_iters, then the full LR
                lr *= warmup_factor
            else:
                alpha = min(step / warmup_iters, 1.0)
                lr *= warmup_factor + (1.0 - warmup_factor) * alpha
        return lr

    return schedule
