"""Processes of a gloo data group on the CPU for the port's data-parallel
tests (``test_torch_port_dist.py``, ``test_torch_port_shard_map.py``,
``test_torch_port_gspmd.py``, ``test_torch_port_gspmd_step.py``).

``run_ranks(target, world, tmp_path, *args)`` starts ``world`` processes
(spawned: each imports this module afresh, and no JAX), each joins a gloo
group through a ``FileStore`` in ``tmp_path`` (``parallel.mesh.make_mesh``)
on one torch thread, calls ``target(mesh, *args)`` and saves what it
returns. The target and its arguments go through a file: a spawned
process that dies before it has read a large argument from its pipe
would leave the parent blocked on writing it. Each process has its own
time limit: one that is still running then is killed and fails the test,
so a hung rank cannot hold the suite.
The targets below are the ranks' sides of the tests; they import the port
only.
"""

import os
import traceback

import numpy as np
import torch

RANK_TIMEOUT = 120.0


def _entry(rank, world, root):
    torch.set_num_threads(1)
    import torch.distributed as tdist
    from mde_tpu_torch.parallel.mesh import make_mesh
    out = os.path.join(root, f"rank{rank}.pt")
    try:
        target, args = torch.load(os.path.join(root, "call.pt"), weights_only=False)
        store = tdist.FileStore(os.path.join(root, "store"), world)
        mesh = make_mesh("cpu", rank=rank, world_size=world, store=store)
        result = target(mesh, *args)
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_ranks(target, world, tmp_path, *args, timeout=RANK_TIMEOUT):
    """``target(mesh, *args)`` on each of ``world`` gloo ranks: the list of
    what each returned, in rank order."""
    import multiprocessing
    root = str(tmp_path)
    torch.save((target, args), os.path.join(root, "call.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(rank, world, root)) for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {timeout} s"
    results = []
    for rank, p in enumerate(procs):
        path = os.path.join(root, f"rank{rank}.pt")
        saved = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        assert p.exitcode == 0 and "ok" in saved, (
            f"rank {rank} exited {p.exitcode}:\n{saved.get('error', '')}")
        results.append(saved["ok"])
    return results


# -- the ranks' sides ----------------------------------------------------

def collectives(mesh):
    """Every collective of ``core/dist.py`` on this rank's values: rank r
    holds r + 1 (the reductions), r (the dict's mean) and the rows 2r,
    2r + 1 of a (world, 2) array (the gather)."""
    from mde_tpu_torch.core import dist
    value = torch.tensor(float(mesh.rank + 1))
    out = {op: dist.all_reduce_tensor(value, op).item()
           for op in ("sum", "mean", "max", "min", "product")}
    out["untouched"] = value.item()
    out["scalar_mean"] = dist.all_reduce_scalar(float(mesh.rank), "mean").item()
    out["dict_mean"] = dist.all_reduce_dict({"m": torch.tensor(float(mesh.rank))})["m"].item()
    rows = torch.arange(2 * mesh.rank, 2 * mesh.rank + 2, dtype=torch.float32)[None]
    out["gather"] = dist.all_gather_tensor(rows, axis=0).numpy()
    out["many"] = [t.numpy() for t in dist.all_reduce_tensors(
        [torch.full((2, 3), mesh.rank + 1.0), torch.tensor([mesh.rank], dtype=torch.int64)],
        "sum")]
    out["process_index"] = dist.process_index()
    # sum_over_ranks: rank r's x is (r + 1) * [1, 2], its loss r + 1 times
    # the first sum plus the second; the backward sums the gradients too
    x = torch.tensor([1.0, 2.0]) * (mesh.rank + 1)
    x.requires_grad_(True)
    dist.reset_collective_counts()
    s1, s2 = dist.sum_over_ranks([x * 1.0, x.sum()])
    ((mesh.rank + 1) * s1.sum() + s2).backward()
    out["sum_over_ranks"] = (s1.detach().numpy(), float(s2), x.grad.numpy(),
                             dist.collective_counts["all_reduce"])
    return out


def shard_map_step(mesh, cfg, model_kw, opt, state, batch, freeze_encoder_bn):
    """One ``make_train_step_shard_map`` step of the model of ``cfg`` from
    the state dict ``state`` on this rank's rows of ``batch``: (the
    gradients the optimizer took, logs, the new state dict)."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.parallel.mesh import replicate, shard_batch
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step_shard_map
    model = build_model(cfg, 0.001, 80.0, device="cpu", seed=mesh.rank, **model_kw)
    if mesh.rank == 0:
        model.load_state_dict(state)
    train_state = replicate(mesh, TrainState.create(model, opt, 100))
    seen = {}
    real = train_state.optimizer.update

    def update(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        real(grads)

    train_state.optimizer.update = update
    step = make_train_step_shard_map(opt, 0.001, 80.0, mesh,
                                     freeze_encoder_bn=freeze_encoder_bn)
    _, logs = step(train_state, shard_batch(mesh, batch), torch.Generator().manual_seed(0))
    return (seen, {k: float(v) for k, v in logs.items()},
            {k: v.clone() for k, v in model.state_dict().items()})


def shard_map_steps_and_fit(mesh, step_args, fit_args):
    """``test_torch_port_shard_map.py``'s ranks, in one group: the
    shard_map step with batch statistics and with ``freeze_encoder_bn``
    (``shard_map_step``), then ``trainer_fit``."""
    return ([shard_map_step(mesh, *step_args, frozen) for frozen in (False, True)],
            trainer_fit(mesh, *fit_args))


def write_kitti_tree(root, train=8, test=2, seed=0):
    """A synthetic KITTI tree under ``root`` (``chip_smoke.write_kitti_tree``'s
    layout, written with the port's PNG codec): ``train`` and ``test``
    samples of 375x1242 RGB and uint16 depth x 256, and the Eigen split
    lists under ``splits/KITTI/`` for ``MDE_SPLIT_DIR``. Returns the
    config's ``dataset`` section."""
    from mde_tpu_torch.data.png import write_png
    rng = np.random.RandomState(seed)
    h, w = 375, 1242
    for mode, n in (("train", train), ("test", test)):
        lines = []
        for i in range(n):
            img = f"2011_09_26/2011_09_26_drive_{mode}_sync/image_02/data/{i:010d}.png"
            gt = f"2011_09_26_drive_{mode}_sync/proj_depth/groundtruth/image_02/{i:010d}.png"
            image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            depth = (rng.uniform(1.0, 80.0, (h, w)) * 256).astype(np.uint16)
            depth[rng.rand(h, w) < 0.3] = 0
            for sub, rel, arr in (("raw", img, image), ("gts", gt, depth)):
                path = os.path.join(root, "data", sub, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_png(path, arr)
            lines.append(f"{img} {gt} 721.5377")
        os.makedirs(os.path.join(root, "splits", "KITTI"), exist_ok=True)
        with open(os.path.join(root, "splits", "KITTI", f"kitti_eigen_{mode}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"data_type": "KITTI", "data_path": os.path.join(root, "data"),
            "img_size": [64, 128]}


def trainer_fit(mesh, opt, model_kw, split_dir):
    """``Trainer.fit(max_steps=2)`` on the CPU with the splits of
    ``split_dir``, then ``Trainer.predict`` into ``predictions/`` of the
    run's directory: (the checkpoints this rank saved, the steps, the
    metrics, the parameters, the predictions this rank wrote)."""
    os.environ["MDE_SPLIT_DIR"] = split_dir
    from mde_tpu_torch.core import checkpoint as ckpt
    from mde_tpu_torch.core.config import load_config
    from mde_tpu_torch.train import driver
    saved = []
    real = ckpt.save_checkpoint

    def save(directory, state, step, **kw):
        saved.append(step)
        return real(directory, state, step, **kw)

    ckpt.save_checkpoint = save
    trainer = driver.Trainer(load_config(opt), model_overrides=model_kw, device="cpu")
    metrics = trainer.fit(max_steps=2)
    written = trainer.predict(os.path.join(opt["output_dir"], "predictions"))
    return (saved, trainer.global_step, metrics,
            {n: p.detach().clone() for n, p in trainer.model.named_parameters()}, written)


# -- the GSPMD step's modules, losses, step and driver -------------------

def _rows(mesh, array):
    """This rank's rows of a global (numpy) batch."""
    n = array.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(array[mesh.rank * n:(mesh.rank + 1) * n]))


def gspmd_batch_norm(mesh, x, weight, dtype, params):
    """``tnn.BatchNorm`` in training inside ``gspmd_scope`` on this rank's
    rows of ``x`` (cast to ``dtype``), from ``params`` (scale, bias,
    running mean and variance), backpropagating the sum of its output
    times this rank's rows of ``weight``: (output, x's gradient, running
    mean, running variance, the scale's and the bias's gradients summed
    over the ranks)."""
    from mde_tpu_torch.core import dist
    from mde_tpu_torch.ops.tnn import BatchNorm
    from mde_tpu_torch.parallel.mesh import gspmd_scope
    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
            t.copy_(torch.from_numpy(v))
    xr = _rows(mesh, x).to(dtype).requires_grad_(True)
    with gspmd_scope(mesh):
        y = bn(xr)
        (y.float() * _rows(mesh, weight)).sum().backward()
    grads = dist.all_reduce_tensors([bn.weight.grad, bn.bias.grad], "sum")
    return (y.detach().float().numpy(), xr.grad.float().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy(), *(g.numpy() for g in grads))


def _record_masks(fn):
    """(``fn()``'s result, every mask ``ops.drop._keep_mask`` gave in it)."""
    from mde_tpu_torch.ops import drop
    real, masks = drop._keep_mask, []

    def keep_mask(*args, **kwargs):
        masks.append(real(*args, **kwargs))
        return masks[-1]

    drop._keep_mask = keep_mask
    try:
        return fn(), masks
    finally:
        drop._keep_mask = real


def draw_site(site, batch, generator, training=True):
    """One site's random draws on ``batch`` (a tensor, this rank's rows or
    the whole batch) from ``generator``: (output, the masks drawn).
    ``dropout``: ``Dropout(0.5)`` on (B, H, W, C); ``drop_path``:
    ``DropPath(0.5).draw`` of B rows, twice, as (B, 2); ``window``: a shifted
    ``SwinBlock``'s stochastic depth, attention dropout over (B * windows,
    heads, 16, 16) and dropout, weights from seed 0."""
    from mde_tpu_torch.models.swin import SwinBlock
    from mde_tpu_torch.ops.drop import Dropout, DropPath
    torch.manual_seed(0)
    if site == "dropout":
        module = Dropout(0.5).train(training)
        return _record_masks(lambda: module(batch, generator))
    if site == "drop_path":
        module = DropPath(0.5).train(training)
        return _record_masks(lambda: torch.stack(
            [module.draw(batch.shape[0], generator, batch.device) for _ in range(2)], dim=1))
    block = SwinBlock(batch.shape[-1], 2, window_size=4, shift_size=2, drop_prob=0.3,
                      attn_drop_prob=0.5, path_drop_prob=0.5).train(training)
    with torch.no_grad():
        return _record_masks(lambda: block(
            batch, block.draw_masks(batch.shape[0], generator, batch.device), generator))


def gspmd_draws(mesh, sites, batch):
    """Each site's ``draw_site`` on this rank's rows of ``batch`` inside
    ``gspmd_scope``, from a generator of seed 3: {site: (output, masks,
    the generator's state after)}."""
    from mde_tpu_torch.parallel.mesh import gspmd_scope
    out = {}
    for site in sites:
        generator = torch.Generator().manual_seed(3)
        with gspmd_scope(mesh):
            y, masks = draw_site(site, _rows(mesh, batch), generator)
        out[site] = (y, masks, generator.get_state())
    return out


def gspmd_loss(mesh, cases, preds, gt, centers):
    """``DepthLoss`` of each loss section in ``cases`` inside
    ``gspmd_scope``, on this rank's rows of the maps ``preds``, ground truth
    ``gt`` and bin centers ``centers``: [(logs, the gradient of the loss
    to this rank's rows of each map, and of the centers)]."""
    from mde_tpu_torch.parallel.mesh import gspmd_scope
    from mde_tpu_torch.train.loss import DepthLoss
    out = []
    for section in cases:
        maps = [_rows(mesh, p).requires_grad_(True) for p in preds]
        bins = _rows(mesh, centers).requires_grad_(True)
        with gspmd_scope(mesh):
            loss, logs = DepthLoss(section, 0.001, 80.0)(maps, _rows(mesh, gt), bins)
            loss.backward()
        out.append(({k: float(v) for k, v in logs.items()},
                    [m.grad.numpy() for m in maps], bins.grad.numpy()))
    return out


def gspmd_step(mesh, cfg, model_kw, opt, state, batch, num_accum, freeze_encoder_bn,
               seed=0):
    """One ``make_train_step_gspmd`` step of the model of ``cfg`` from the
    state dict ``state`` on the whole ``batch`` (rank 1 starts from other
    weights and takes rank 0's through ``replicate``), its draws from a
    generator of ``seed``: (the gradients the optimizer took, logs, the new
    state dict, the all-reduces launched, the BatchNorm modules, those in
    checkpointed blocks, the maps the loss took)."""
    from mde_tpu_torch.core import dist
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import remat
    from mde_tpu_torch.ops.tnn import BatchNorm
    from mde_tpu_torch.parallel.mesh import replicate
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import default_adapter, make_train_step_gspmd
    model = build_model(cfg, 0.001, 80.0, device="cpu", seed=mesh.rank, **model_kw)
    if mesh.rank == 0:
        model.load_state_dict(state)
    train_state = replicate(mesh, TrainState.create(model, opt, 100))
    seen = {}
    real = train_state.optimizer.update

    def update(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        real(grads)

    train_state.optimizer.update = update
    blocks, maps = set(), []

    class Checkpoint(remat._Checkpoint):
        def __init__(self, block, *args):
            blocks.add(block)
            super().__init__(block, *args)

    def forward(*args, real=model.forward, **kwargs):
        out = real(*args, **kwargs)
        maps.append(len(default_adapter(out)[0]))
        return out

    step = make_train_step_gspmd(opt, 0.001, 80.0, mesh, num_accum=num_accum,
                                 freeze_encoder_bn=freeze_encoder_bn)
    model.forward, remat._Checkpoint = forward, Checkpoint
    try:
        dist.reset_collective_counts()
        _, logs = step(train_state, batch, torch.Generator().manual_seed(seed))
        launched = dist.collective_counts["all_reduce"]
    finally:
        remat._Checkpoint = Checkpoint.__base__
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    in_blocks = sum(isinstance(m, BatchNorm) for b in blocks for m in b.modules())
    return (seen, {k: float(v) for k, v in logs.items()},
            {k: v.clone() for k, v in model.state_dict().items()},
            launched, len(norms), in_blocks, maps[0])


def gspmd_steps(mesh, step_args, variants):
    """``gspmd_step`` of ``step_args`` for each (num_accum,
    freeze_encoder_bn) of ``variants``, in one group."""
    return [gspmd_step(mesh, *step_args, *variant) for variant in variants]


def gspmd_case(mesh, modules, step_args, fit_args):
    """``test_torch_port_gspmd.py``'s ranks, in one group: ``gspmd_batch_norm``
    of each of ``modules['bn']``, ``gspmd_draws``, ``gspmd_loss``, the
    dropout step (``gspmd_step`` of ``step_args``), ``trainer_fit``, and a
    'gspmd' ``Trainer`` whose loader batch does not split over the ranks
    (its error)."""
    bn = [gspmd_batch_norm(mesh, *case) for case in modules["bn"]]
    draws = gspmd_draws(mesh, *modules["draws"])
    loss = gspmd_loss(mesh, *modules["loss"])
    step = gspmd_step(mesh, *step_args)
    fit = trainer_fit(mesh, *fit_args)
    from mde_tpu_torch.core.config import load_config
    from mde_tpu_torch.train import driver
    opt = fit_args[0]
    try:
        driver.Trainer(load_config(dict(opt, dataloader=dict(opt["dataloader"], batch_size=3))),
                       model_overrides=fit_args[1], device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return bn, draws, loss, step, fit, refused


# -- tensor-parallel feed-forwards over a (data, model) mesh -------------

def tp_steps(mesh, n_model, step_args, variants):
    """``gspmd_step`` of ``step_args`` on the ``(world / n_model, n_model)``
    mesh of this group (``make_mesh(..., n_model=)``), once for each
    (num_accum, freeze_encoder_bn) of ``variants``: [(this rank's (data,
    model) place, ``gspmd_step``'s result)]."""
    from mde_tpu_torch.parallel.mesh import make_mesh
    grid = make_mesh("cpu", n_model=n_model)
    return [((grid.rank, grid.model_rank), gspmd_step(grid, *step_args, *variant))
            for variant in variants]
