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
from .models.specs import Linear


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


# ------------------------------------------------------------------ sharding

def param_shardings(model, mesh, tp_axis="tp", min_tp_features=512):
    """{layer: {name: spec}}, keynet_tpu's PartitionSpecs as tuples: Linear
    weights with in_features >= ``min_tp_features`` and divisible by the tp
    size split over tp along in_features, ``(None, tp_axis)``; everything
    else replicates, ``()``."""
    tree = {}
    for l in model.layers:
        if l.name not in model.params:
            continue
        tree[l.name] = {
            k: (None, tp_axis) if (isinstance(l, Linear) and k == "weight"
                                   and l.in_features >= min_tp_features
                                   and tp_axis in mesh.axis_names
                                   and l.in_features % mesh.size(tp_axis) == 0) else ()
            for k in model.params[l.name]}
    return tree


def _tp_cols(spec, mesh, width):
    """[a, b): this rank's columns of a leaf split as ``spec``."""
    if not spec:
        return 0, width
    k = width // mesh.size(spec[1])
    j = mesh.coords[spec[1]]
    return j * k, (j + 1) * k


def shard_params(params, p_shard, mesh):
    """This rank's leaves of a full params tree ({layer: {name: tensor or
    array}}) split as ``p_shard``: leaf tensors on the mesh's device that
    require grad, for make_optimizer and the sharded step."""
    out = {}
    for k, d in params.items():
        out[k] = {}
        for kk, v in d.items():
            v = torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v),
                                dtype=torch.float32)
            if p_shard[k][kk]:
                a, b = _tp_cols(p_shard[k][kk], mesh, v.shape[1])
                v = v[:, a:b]
            out[k][kk] = v.to(mesh.device).clone().requires_grad_(True)
    return out


def gather_params(params, p_shard, mesh):
    """The full params tree as numpy arrays, on every rank: tp-split leaves
    all-gathered over tp along in_features."""
    from .parallel.sharding import all_gather_cat
    with torch.no_grad():
        return {k: {kk: (all_gather_cat(v, mesh, p_shard[k][kk][1], 1)
                         if p_shard[k][kk] else v).cpu().numpy()
                    for kk, v in d.items()} for k, d in params.items()}


class _TpSplit(torch.autograd.Function):
    """Forward: this rank's columns of an input replicated over tp.
    Backward: the ranks' column gradients all-gathered, so the layers
    upstream get the whole input gradient on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        a, b = _tp_cols((None, axis), mesh, x.shape[1])
        return x[:, a:b].clone()

    @staticmethod
    def backward(ctx, g):
        from .parallel.sharding import all_gather_cat
        return all_gather_cat(g, ctx.mesh, ctx.axis, 1), None, None


class _TpReduce(torch.autograd.Function):
    """Forward: the sum over tp of the ranks' partial products.  Backward:
    identity; the loss is computed whole on every tp rank, so each partial
    product's gradient is the output's (an all_reduce here, as
    torch.distributed.nn.functional.all_reduce takes, would make it tp
    times too large)."""

    @staticmethod
    def forward(ctx, partial, mesh, axis):
        from .parallel.sharding import all_reduce_sum
        return all_reduce_sum(partial, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def make_sharded_train_step(model, optimizer, mesh, dp_axis="dp", tp_axis="tp"):
    """The training step over a (dp, tp) mesh (keynet_tpu/train.py:142-161):
    batch rows split over dp, the Linear weights of param_shardings over tp.
    Returns (step, p_shard, batch_shard, label_shard), the last three as
    spec tuples.  ``optimizer`` (make_optimizer) holds this rank's leaves
    (shard_params).  step(params, images, labels) takes the full batch
    (rows divisible by dp), runs this rank's rows with the tp layers as
    all_reduce(x[:, shard] @ W_shardᵀ) + b, averages every gradient over
    dp, steps the optimizer and returns the loss of the full batch."""
    p_shard = param_shardings(model, mesh, tp_axis)
    tp_layers = {k for k, d in p_shard.items() if d.get("weight")}
    dp = mesh.size(dp_axis)

    def linear(layer, x, W, b):
        if layer.name not in tp_layers:
            return torch.matmul(x, W.T) + b
        xs = _TpSplit.apply(x, mesh, tp_axis)
        return _TpReduce.apply(torch.matmul(xs, W.T), mesh, tp_axis) + b

    def step(params, images, labels):
        from .parallel.sharding import _rows, all_reduce_sum
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels)
        a, b = _rows(images.shape[0], mesh, dp_axis, "make_sharded_train_step")
        xb = images[a:b].to(mesh.device, torch.float32)
        yb = labels[a:b].to(mesh.device)
        optimizer.zero_grad(set_to_none=True)
        loss = log_softmax_nll(model.forward(xb, params=params, linear=linear), yb)
        loss.backward()
        with torch.no_grad():
            for v in _leaves(params):
                if v.grad is not None:
                    v.grad.copy_(all_reduce_sum(v.grad, mesh, dp_axis) / dp)
        optimizer.step()
        return all_reduce_sum(loss.detach(), mesh, dp_axis) / dp

    return step, p_shard, (dp_axis, None, None, None), (dp_axis,)
