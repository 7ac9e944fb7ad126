"""Trainer: the reference's optimization recipe on one device (counterpart of
multi_modal_image_fusion_tpu train/trainer.py; reference train.py:302-324):

    Adam(lr=1e-4, betas=(0.9, 0.999)) + MultiStepLR(2/3E, 8/9E; x0.1)
    + optional first-epoch warmup + global-norm grad clip at 5
    loss = SSIMLoss('ssim', w=1) + PixelLoss('l1','max', w=0.01)
         + GradLoss('l1','max', w=0.1)

The update matches optax's chain (clip_by_global_norm, scale_by_adam,
scale_by_learning_rate), not torch's optimizers: the clip scales by
max_norm / ||g|| only when ||g|| >= max_norm (no epsilon, unlike
torch.nn.utils.clip_grad_norm_), Adam's eps is added outside the square
root, and update t (counted from 0) uses schedule(t). Nothing in a step
waits for the host: the clip decision, the loss parts and the returned
images stay on the device. Parameters and moments are updated in place.

The trainer owns the state: the model's parameters, the Adam moments `mu`,
`nu` and `step` (optax's count and the JAX TrainState's step, which move
together). `state_dict()` / `load_state_dict()` carry the optimizer part
for resume.
"""

import contextlib

import torch
from torch.func import functional_call
from torch.profiler import record_function

from ..ops.layers import fast_training
from ..ops.losses import GradLoss, PixelLoss, SSIMLoss

__all__ = ["Trainer", "clip_by_global_norm", "make_loss_bundle"]


@contextlib.contextmanager
def _mode(model, train):
    """The model in train (`train`) or eval mode, its mode restored after:
    the port's counterpart of the JAX package's `train` argument. A batch
    norm takes the batch statistics, and moves its running ones, only in
    train mode (ops/layers.batch_norm)."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def make_loss_bundle(ssim_mode="ssim", ssim_weight=1.0,
                     pixel_mode="l1", pixel_weight=0.01,
                     grad_mode="l1", grad_weight=0.1,
                     pixel_grad_mode="max"):
    """The reference's 3-loss bundle; returns f(img1, img2, imgf, mask=None)
    -> (total, dict of components)."""
    loss_fn1 = SSIMLoss(ssim_mode, weight=ssim_weight)
    loss_fn2 = PixelLoss(pixel_mode, weight=pixel_weight)
    loss_fn3 = GradLoss(grad_mode, weight=grad_weight)

    def bundle(img1, img2, imgf, mask=None):
        l1 = loss_fn1(img1, img2, imgf, mask=mask)
        l2 = loss_fn2(img1, img2, imgf, mode=pixel_grad_mode, mask=mask)
        l3 = loss_fn3(img1, img2, imgf, mode=pixel_grad_mode, mask=mask)
        total = l1 + l2 + l3
        return total, {"loss": total, "loss1": l1, "loss2": l2, "loss3": l3}

    return bundle


def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm: every gradient times max_norm / ||g|| when
    the global norm ||g|| >= max_norm, unchanged below it; decided on the
    device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Trainer:
    """Train and valid steps of a model with the reference recipe.

    `ae=True`: autoencoder-reconstruction mode for two-stage pretraining
    (batches are single images, the model runs with img2=None and the loss
    compares the reconstruction with the input). `fast=True`: the steps run
    inside `fast_training`, so every conv goes through the conv_valid kernels
    on the card (ops/layers.py). `amp="bf16"`: f32 master parameters cast to
    bf16 at the model boundary, the output cast back to f32; the loss, the
    gradients, the Adam moments and the batch norms' statistics and
    running buffers stay f32, and the valid step is f32. A train step runs
    the model in train mode (batch norms on the batch statistics, which
    move the running ones), a valid step in eval mode (the running
    statistics, nothing moves); each restores the mode it found.
    """

    def __init__(self, model, lr_schedule, loss_bundle=None, clip_grad=5.0,
                 betas=(0.9, 0.999), ae=False, fast=False, amp=None):
        if amp not in (None, "f32", "bf16"):
            raise ValueError(f"amp {amp!r} (None, 'f32' or 'bf16')")
        self.model = model
        self.schedule = lr_schedule
        self.loss_bundle = loss_bundle or make_loss_bundle()
        self.clip_grad = clip_grad
        self.b1, self.b2 = betas
        self.eps = 1e-8
        self.ae = ae
        self.fast = fast
        self.amp = None if amp == "f32" else amp
        self.params = dict(model.named_parameters())
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.step = 0

    # -- state -----------------------------------------------------------
    def state_dict(self):
        """Optimizer state for resume: step and the Adam moments, on the
        host."""
        return {"step": self.step,
                "mu": {n: t.detach().to("cpu", copy=True)
                       for n, t in self.mu.items()},
                "nu": {n: t.detach().to("cpu", copy=True)
                       for n, t in self.nu.items()}}

    def load_state_dict(self, state):
        for key in ("mu", "nu"):
            src = state[key]
            if set(src) != set(self.params):
                raise ValueError(f"optimizer state {key} holds "
                                 f"{sorted(src)}, the model "
                                 f"{sorted(self.params)}")
            for n, t in getattr(self, key).items():
                t.copy_(src[n])
        self.step = int(state["step"])

    # -- steps -----------------------------------------------------------
    def _unpack(self, batch):
        if self.ae:
            img = batch[0] if isinstance(batch, (tuple, list)) else batch
            return img, None
        img1, img2 = batch
        return img1, img2

    def _apply(self, img1, img2, train):
        if train and self.amp == "bf16":
            bf = torch.bfloat16
            params = {n: p.to(bf) for n, p in self.params.items()}
            out = functional_call(self.model, params, (
                img1.to(bf), None if img2 is None else img2.to(bf)))
            return out.float()
        return self.model(img1, img2)

    def train_step(self, batch):
        """One update; returns (loss parts, fused output), both detached and
        on the device."""
        img1, img2 = self._unpack(batch)
        tgt2 = img1 if img2 is None else img2
        with fast_training(self.fast), _mode(self.model, True):
            with record_function("forward"):
                imgf = self._apply(img1, img2, train=True)
            with record_function("loss"):
                total, parts = self.loss_bundle(img1, tgt2, imgf)
            # a parameter the loss does not reach (Res2ConvBlock's dead
            # dwconv) gets a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(total, list(self.params.values()),
                                        materialize_grads=True)
        with torch.no_grad(), record_function("optimizer"):
            self._update(grads)
        return {k: v.detach() for k, v in parts.items()}, imgf.detach()

    def _update(self, grads):
        if self.clip_grad:
            grads = clip_by_global_norm(grads, self.clip_grad)
        lr = self.schedule(self.step)
        self.step += 1
        bc1 = 1.0 - self.b1 ** self.step
        bc2 = 1.0 - self.b2 ** self.step
        for (n, p), g in zip(self.params.items(), grads):
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.add_((mu / bc1) / ((nu / bc2).sqrt() + self.eps), alpha=-lr)

    def train_steps(self, batches):
        """K steps over stacked (K, B, ...) batches (the JAX package's
        lax.scan over K steps); returns (per-step loss parts stacked (K,),
        last fused output)."""
        parts, imgf = [], None
        for i in range(len(batches[0] if isinstance(batches, (tuple, list))
                           else batches)):
            batch = (tuple(b[i] for b in batches)
                     if isinstance(batches, (tuple, list)) else batches[i])
            p, imgf = self.train_step(batch)
            parts.append(p)
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}, imgf

    def valid_step(self, batch, mask=None):
        """Loss parts and fused output without an update, f32. mask: optional
        (N,) 0/1 tensor excluding samples from the loss average."""
        img1, img2 = self._unpack(batch)
        tgt2 = img1 if img2 is None else img2
        with torch.no_grad(), fast_training(self.fast), \
                _mode(self.model, False):
            imgf = self._apply(img1, img2, train=False)
            _, parts = self.loss_bundle(img1, tgt2, imgf, mask=mask)
        return parts, imgf
