"""PyTorch port vs the JAX package: ``parallel/`` (sharded render loss,
gradients and train step, the collectives, the bootstrap).

Four gloo ranks run in spawned processes (``tests/torch_parallel_worker.py``,
FileStore in ``tmp_path``, a join deadline so a hung collective fails the
test). They compute the port's sharded loss and gradients on a 2×2 and a 1×4
mesh, each collective's gradient, and one Adam step. These are held against
the port's 1×1 mesh in this process, against the JAX package's
``make_sharded_render_loss`` on the same mesh shapes of the virtual CPU
devices ``tests/conftest.py`` forces, and against one optax Adam step.
Float32, torch on one thread. Tolerances:
  * the loss: relative 1e-5 (the same sums split over bands and ranks);
  * a gradient group: max |d| ≤ 1e-5 · the largest reference gradient of
    any group (per-band sums in another order; measured ≤ 3e-7 against the
    port's 1×1 mesh and against JAX, whose jnp blend sums in another order
    than the port's plain blend);
  * the collectives and the Adam step: 1e-6 absolute (one product or sum).
The scene keeps every band's ``n_isects`` under the JAX config's capacity
and every ``tile_cnt`` under its ``max_per_tile`` (ROADMAP §C hazards 4-5).
"""

import functools
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.models.gaussians import init_random as jinit_random
from gaussctrl_exp_tpu.parallel import sharded as jsh
from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams
from gaussctrl_exp_tpu_torch.parallel import sharded as S
from gaussctrl_exp_tpu_torch.parallel import distributed
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "torch_parallel_worker.py"
H = W = 64
LR = 5e-3
ISECT_CAPACITY, MAX_PER_TILE = 1 << 12, 512  # the JAX config's limits
LOSS_RTOL, GRAD_REL, EXACT = 1e-5, 1e-5, 1e-6
STEP = 1000  # SH degree 1: features_rest takes a gradient
JOIN_S = 240


def run_workers(job: str, world: int, d: Path) -> list[dict]:
    """Spawn ``world`` ranks of ``job`` and wait for all of them until a
    deadline; a rank that has not ended by then is killed and fails the test."""
    procs = [subprocess.Popen([sys.executable, str(WORKER), job, str(r), str(world), str(d)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline, logs = time.monotonic() + JOIN_S, []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {job} rank did not finish within {JOIN_S} s (hung collective?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(d / f"{job}_rank{r}.npz")) for r in range(world)]


@functools.lru_cache(maxsize=None)
def _scene():
    """tests/test_sharding.py's scene: 96 gaussians at capacity 128, SH 1,
    two cameras at 64², uniform random targets."""
    gs = jinit_random(96, capacity=128, sh_degree=1, seed=3)
    arrays = {n: np.asarray(getattr(gs.params, n)) for n in PARAM_NAMES}
    cams = []
    for i in range(2):
        eye = np.array([4.0 * np.sin(0.4 * i), -4.0 * np.cos(0.4 * i), 1.0])
        cams.append(jmake_camera(jlook_at(eye, np.zeros(3)), 80.0, 80.0, W / 2, H / 2, W, H))
    cam = {k: np.stack([np.asarray(getattr(c, k)) for c in cams]) for k in ("c2w", "fx", "fy", "cx", "cy")}
    gt = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return dict(arrays, alive=np.asarray(gs.alive), gt=gt, **cam)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "inputs.npz", H=H, W=W, sh_degree=1, lr=LR, step=STEP, **scene)
    return run_workers("sharded", 4, d)


def port_params(scene) -> GaussianParams:
    return GaussianParams(**{n: torch.tensor(scene[n]) for n in PARAM_NAMES})


def cam_arrays(scene, b: slice):
    return tuple(torch.as_tensor(scene[k][b]) for k in ("c2w", "fx", "fy", "cx", "cy"))


def one_by_one(scene, b: int):
    """The port's loss and gradients for camera b on a 1×1 mesh (no process group)."""
    mesh = S.make_mesh(1, 1, device="cpu")
    shard, al = S.shard_params(port_params(scene), torch.as_tensor(scene["alive"]), mesh)
    loss = S.make_sharded_render_loss(mesh, S.ShardedRenderConfig(height=H, width=W, sh_degree=1))(
        shard, al, cam_arrays(scene, slice(b, b + 1)), torch.as_tensor(scene["gt"][b : b + 1]), STEP)
    loss.backward()
    return float(loss.detach()), {n: getattr(shard, n).grad.numpy() for n in PARAM_NAMES}


@functools.lru_cache(maxsize=None)
def jax_sharded(data: int, model: int, cams: tuple = (0, 1)):
    """The JAX package's sharded loss and gradients for cameras ``cams``
    (the first ``data``) on a data × model mesh of the virtual CPU devices
    (jnp blend)."""
    scene = dict(_scene())
    scene.update({k: scene[k][list(cams)] for k in ("c2w", "fx", "fy", "cx", "cy", "gt")})
    mesh = jsh.make_mesh(data, model, devices=jax.devices()[: data * model])
    cfg = jsh.ShardedRenderConfig(height=H, width=W, isect_capacity_per_device=ISECT_CAPACITY, sh_degree=1,
                                  impl="jnp", max_per_tile=MAX_PER_TILE)
    from gaussctrl_exp_tpu.models.gaussians import GaussianParams as JParams

    params = JParams(**{n: jnp.asarray(scene[n]) for n in PARAM_NAMES})
    ps, al = jsh.shard_params(params, jnp.asarray(scene["alive"]), mesh)
    cams = tuple(jnp.asarray(scene[k][:data]) for k in ("c2w", "fx", "fy", "cx", "cy"))
    loss_fn = jsh.make_sharded_render_loss(mesh, cfg)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, al, cams, jnp.asarray(scene["gt"][:data]),
                                                                jnp.int32(STEP))))(ps)
    return float(loss), {n: np.asarray(getattr(grads, n)) for n in PARAM_NAMES}


def assembled(ranks, tag: str, data: int, model: int) -> dict:
    """The full gradient from the model ranks' shards; every data group's
    copy of a shard must be the same."""
    by = {tuple(r[f"{tag}_coords"]): r for r in ranks}
    out = {}
    for n in PARAM_NAMES:
        for d in range(1, data):
            for m in range(model):
                np.testing.assert_array_equal(by[(d, m)][f"{tag}_grad_{n}"], by[(0, m)][f"{tag}_grad_{n}"])
        out[n] = np.concatenate([by[(0, m)][f"{tag}_grad_{n}"] for m in range(model)])
    return out


def assert_grads_close(got: dict, want: dict):
    scale = max(float(np.abs(want[n]).max()) for n in PARAM_NAMES)
    assert float(np.abs(want["features_rest"]).max()) > 0.0
    for n in PARAM_NAMES:
        assert float(np.abs(got[n] - want[n]).max()) <= GRAD_REL * scale, n


def test_collectives_and_their_gradients(ranks):
    """Each Function forward and backward against its definition, from all
    four ranks' inputs and weights (rank-seeded)."""
    xs = [torch.randn((3, 2), generator=torch.Generator().manual_seed(r)).numpy() for r in range(4)]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["gather"], np.concatenate(xs), atol=EXACT)
        # the all-gather's backward: the sum over ranks of this rank's rows
        want = sum(o["gather_w"][3 * r : 3 * r + 3] for o in ranks)
        np.testing.assert_allclose(out["gather_grad"], want, atol=EXACT)
        # the halo: rank r receives rank r+1's rows, and its rows get rank r−1's halo gradient
        halo_x = torch.randn((2, 3), generator=torch.Generator().manual_seed(r + 1)).numpy() if r < 3 else 0.0
        np.testing.assert_allclose(out["halo"], halo_x + np.zeros((2, 3)), atol=EXACT)
        np.testing.assert_allclose(out["halo_grad"], ranks[r - 1]["halo_w"] if r else np.zeros((2, 3)), atol=EXACT)
        # a replicated loss: the sum's gradient is the rank's own weight, not 4×; the mean's a quarter
        np.testing.assert_allclose(out["sum_grad"], out["sum_w"], atol=EXACT)
        np.testing.assert_allclose(out["mean_grad"], out["mean_w"] / 4, atol=EXACT)
        # a replicated input: the gradients of all ranks summed
        np.testing.assert_allclose(out["replicated_grad"], sum(o["replicated_w"] for o in ranks), atol=EXACT)


@pytest.mark.parametrize("tag,data,model", [("2x2", 2, 2), ("1x4", 1, 4)])
def test_sharded_loss_and_grads_match_the_1x1_mesh(scene, ranks, tag, data, model):
    refs = [one_by_one(scene, b) for b in range(data)]
    want_loss = float(np.mean([r[0] for r in refs]))
    want = {n: np.mean([r[1][n] for r in refs], axis=0) for n in PARAM_NAMES}
    for out in ranks:
        assert abs(float(out[f"{tag}_loss"]) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert_grads_close(assembled(ranks, tag, data, model), want)


@pytest.mark.parametrize("tag,data,model", [("2x2", 2, 2), ("1x4", 1, 4)])
def test_sharded_loss_and_grads_match_jax(scene, ranks, tag, data, model):
    for out in ranks:  # within the JAX config's limits, so neither side truncates
        assert out[f"{tag}_n_isects"] <= ISECT_CAPACITY and out[f"{tag}_tile_cnt_max"] <= MAX_PER_TILE
    jloss, jgrads = jax_sharded(data, model)
    for out in ranks:
        assert abs(float(out[f"{tag}_loss"]) - jloss) <= LOSS_RTOL * abs(jloss)
    assert_grads_close(assembled(ranks, tag, data, model), jgrads)


def test_jax_sharded_grads_equal_its_1x1_mesh():
    """The reference's own relation, which the port's tests rely on: JAX's
    2×2 gradient is the mean over the two cameras of its 1×1 gradients."""
    loss, grads = jax_sharded(2, 2)
    ones = [jax_sharded(1, 1, (b,)) for b in range(2)]
    assert abs(loss - np.mean([o[0] for o in ones])) <= LOSS_RTOL * abs(loss)
    assert_grads_close(grads, {n: np.mean([o[1][n] for o in ones], axis=0) for n in PARAM_NAMES})


def test_sharded_adam_step_matches_optax(scene, ranks):
    """One ``make_sharded_train_step`` with ``torch.optim.Adam`` equals one
    ``optax.adam`` update of the same gradients."""
    grads = assembled(ranks, "2x2", 2, 2)
    params = {n: jnp.asarray(scene[n]) for n in PARAM_NAMES}
    opt = optax.adam(LR)
    updates, _ = opt.update({n: jnp.asarray(grads[n]) for n in PARAM_NAMES}, opt.init(params), params)
    by = {tuple(r["2x2_coords"]): r for r in ranks}
    for n in PARAM_NAMES:
        got = np.concatenate([by[(0, m)][f"adam_{n}"] for m in range(2)])
        np.testing.assert_allclose(got, np.asarray(params[n] + updates[n]), atol=EXACT, err_msg=n)
    assert float(by[(0, 0)]["adam_loss"]) == float(by[(0, 0)]["2x2_loss"])


def test_shard_params_pads_to_a_multiple_of_model():
    """Capacity 130 over 4 model ranks: 132 rows, 33 a rank, the 2 pads zero
    and not alive, as the JAX package's ``shard_params`` pads."""
    rng = np.random.default_rng(0)
    params = GaussianParams(**{n: torch.as_tensor(rng.normal(size=(130, *s)).astype(np.float32))
                               for n, s in zip(PARAM_NAMES, [(3,), (3,), (4,), (3,), (3, 3), (1,)])})
    alive = torch.ones(130, dtype=torch.bool)
    shards = []
    for m in range(4):
        mesh = S.Mesh(("data", "model"), {"data": 1, "model": 4}, {"data": 0, "model": m},
                      {"data": None, "model": None}, torch.device("cpu"))
        shards.append(S.shard_params(params, alive, mesh))
    for n in PARAM_NAMES:
        full = torch.cat([getattr(p, n) for p, _ in shards])
        assert full.shape[0] == 132 and all(getattr(p, n).requires_grad for p, _ in shards)
        assert torch.equal(full[:130], getattr(params, n)) and not full[130:].any()
    assert torch.cat([a for _, a in shards]).tolist() == [True] * 130 + [False] * 2


def test_initialize_distributed_without_a_coordinator(monkeypatch):
    """No coordinator and no count: nothing starts, False, rank 0."""
    for k in ("GCTPU_COORDINATOR", "GCTPU_NUM_PROCESSES", "GCTPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed(device="cpu") is False
    assert distributed.process_index() == 0 and distributed.is_main_process()
    mesh = distributed.make_global_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {"data": None, "model": None}
