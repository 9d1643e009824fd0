"""Source-model training on torch.optim, replicating the reference recipes.

Reference: keynet/mnist.py:66-89 (SGD lr .003 momentum .9, NLL loss, 20
epochs, batch 64) and keynet/cifar10.py:104-140 (SGD lr .01 momentum .9,
weight decay 1e-3, MultiStepLR [200,250,300] gamma .1, 350 epochs).  The
port of keynet_tpu/train.py:25-117: the loss is differentiated by autograd
through the model spec's forward (cuDNN convs and cuBLAS matmuls in IEEE
f32, globals.precision), and the update is torch.optim.SGD, which is the
update of optax's add_decayed_weights followed by sgd with momentum.

Nothing is downloaded: the loops take any (images, labels) numpy iterator;
keynet_tpu_torch.datasets provides loaders for locally available data.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .globals import precision, resolve_device


def log_softmax_nll(logits, labels):
    """F.nll_loss(F.log_softmax(x)) of the reference training loops."""
    return F.nll_loss(F.log_softmax(logits, dim=-1), labels.long())


def accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).float().mean()


def params_tree(model, device):
    """The model's numpy params as leaf tensors on ``device`` that require
    grad: {layer: {name: tensor}}."""
    return {k: {kk: torch.tensor(np.asarray(vv, dtype=np.float32), device=device,
                                 requires_grad=True) for kk, vv in d.items()}
            for k, d in model.params.items()}


def _leaves(params):
    return [v for d in params.values() for v in d.values()]


def make_optimizer(params, lr=0.003, momentum=0.9, weight_decay=0.0, milestones=None,
                   gamma=0.1, steps_per_epoch=1):
    """SGD+momentum with optional weight decay and MultiStepLR schedule over
    the tensors of ``params`` ({layer: {name: tensor}}); returns
    (optimizer, scheduler).

    `milestones` are EPOCH numbers (the reference's MultiStepLR semantics,
    keynet/cifar10.py:118); the scheduler steps once per optimizer STEP, so
    they are converted with `steps_per_epoch` (batches per epoch).  Step c
    runs at lr·gamma^(number of milestones m with m·steps_per_epoch <= c), the
    boundary of optax's piecewise_constant_schedule."""
    opt = torch.optim.SGD(_leaves(params), lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    bounds = sorted(int(m) * int(steps_per_epoch) for m in (milestones or ()))
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: gamma ** sum(step >= b for b in bounds))
    return opt, sched


def make_train_step(model, optimizer, scheduler=None, loss_fn=log_softmax_nll):
    """(params, images, labels) -> loss: one SGD step on ``params`` (the
    tensors ``optimizer`` updates, in place) on a batch already on their
    device."""

    def step(params, images, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model.forward(images, params=params), labels)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    return step


def train(model, data_iter_fn, epochs=20, lr=0.003, momentum=0.9,
          weight_decay=0.0, milestones=None, steps_per_epoch=None, verbose=True,
          device="cuda"):
    """Train a keynet_tpu_torch Model on ``device``; data_iter_fn(epoch)
    yields (images, labels) numpy batches.  Writes the trained params back
    to model.params as numpy arrays and returns the model.  With epoch
    `milestones`, `steps_per_epoch` (batches per epoch) is required so the
    LR decays at the reference's MultiStepLR epoch boundaries."""
    if milestones and not steps_per_epoch:
        raise ValueError("epoch milestones need steps_per_epoch to convert to "
                         "optimizer steps (the scheduler counts steps)")
    device = resolve_device(device)
    precision()
    params = params_tree(model, device)
    opt, sched = make_optimizer(params, lr, momentum, weight_decay, milestones,
                                steps_per_epoch=steps_per_epoch or 1)
    step = make_train_step(model, opt, sched)
    for e in range(epochs):
        running, nb = 0.0, 0
        for images, labels in data_iter_fn(e):
            l = step(params, torch.as_tensor(np.asarray(images), device=device),
                     torch.as_tensor(np.asarray(labels), device=device))
            running += float(l)
            nb += 1
        if verbose:
            print("Epoch %d - Training loss: %f" % (e, running / max(nb, 1)))
    model.params = {k: {kk: vv.detach().cpu().numpy() for kk, vv in d.items()}
                    for k, d in params.items()}
    return model


def validate(model, data_iter, secret_sensor=None, secret_knet=None, verbose=True,
             device="cuda"):
    """Top-1 accuracy; with (secret_sensor, secret_knet) the batch is encrypted
    and evaluated through the keynet on its device instead (reference
    keynet/mnist.py:92-108 `validate(..., secretkey)`), else the source model
    runs on ``device``."""
    if secret_knet is None:
        device = resolve_device(device)
    total, correct = 0, 0
    with torch.no_grad():
        for images, labels in data_iter:
            if secret_knet is not None:
                xc = secret_sensor.fromtensor(images).encrypt().tensor()
                logits = secret_knet.forward(xc).reshape(len(labels), -1)
            else:
                logits = model.forward(images, device=device)
            correct += int((logits.argmax(dim=1).cpu().numpy() == np.asarray(labels)).sum())
            total += len(labels)
    acc = correct / max(total, 1)
    if verbose:
        print("Mean classification accuracy = %f" % acc)
    return acc
