"""The last names of the JAX package that the port gained: vector.check_envs,
models.layer_init_dense / orthogonal_init, training.checkpoint.save_pytree /
load_pytree and simple_demo_torch.py, each against its JAX counterpart on
the CPU; and an AST diff of the two packages' public top-level names,
which leaves only ppo.suggest_minibatch_size (a TPU VMEM budget, out on
purpose)."""
import ast
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu import vector as jvector
from pufferlib_tpu.exceptions import APIUsageError as JaxAPIUsageError
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import layer_init_dense as jax_layer_init_dense
from pufferlib_tpu.training import checkpoint as jax_checkpoint

from pufferlib_tpu_torch import spaces, vector
from pufferlib_tpu_torch.convert import default_state_dict
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import (
    Default, layer_init_dense, orthogonal_init)
from pufferlib_tpu_torch.models._layers import _linear
from pufferlib_tpu_torch.training import checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# observation spaces of both packages, by name
SPACES = {
    'box 4': lambda m: m.Box(-1.0, 1.0, (4,), np.float32),
    'box 4 again': lambda m: m.Box(-1.0, 1.0, (4,), np.float32),
    'box 5': lambda m: m.Box(-1.0, 1.0, (5,), np.float32),
    'box 4 uint8': lambda m: m.Box(0, 255, (4,), np.uint8),
    'box 4 wide': lambda m: m.Box(-2.0, 2.0, (4,), np.float32),
    'discrete 3': lambda m: m.Discrete(3),
    'discrete 4': lambda m: m.Discrete(4),
    'dict': lambda m: m.Dict({'a': m.Discrete(3),
        'b': m.Box(0, 1, (2,), np.float32)}),
    'dict other': lambda m: m.Dict({'a': m.Discrete(4),
        'b': m.Box(0, 1, (2,), np.float32)}),
}


class _Env:
    def __init__(self, space):
        self.observation_space = space


def _refuses(check, error, module, env_names, base_name):
    try:
        check([_Env(SPACES[n](module)) for n in env_names],
            _Env(SPACES[base_name](module)))
    except error as e:
        return str(e)
    return None


@pytest.mark.parametrize('base', sorted(SPACES))
def test_check_envs_matches_jax(base):
    """Every space as the one compared against, with every other, one env
    and two: the port accepts and refuses the pairs JAX does, with its
    message."""
    for name in SPACES:
        for envs in ([name], [base, name]):
            want = _refuses(jvector.check_envs, JaxAPIUsageError, jspaces,
                envs, base)
            got = _refuses(vector.check_envs, APIUsageError, spaces, envs,
                base)
            assert got == want, (envs, base)


@pytest.mark.parametrize('shape,std', [((16, 6), math.sqrt(2)),
    ((6, 16), 0.01), ((8, 8), 1.0)])
def test_layer_init_dense_matches_jax(shape, std):
    """orthogonal of gain std (W W^T = std^2 I over the shorter side),
    zero bias, float32; carried the JAX Dense's kernel it computes the
    JAX layer on the same input, in f32 and bf16."""
    in_features, out_features = shape
    layer = layer_init_dense(in_features, out_features, std,
        torch.Generator().manual_seed(0))
    w = layer.weight.detach().double()
    gram = w @ w.T if out_features <= in_features else w.T @ w
    np.testing.assert_allclose(gram.numpy(), std ** 2 * np.eye(
        min(shape)), atol=1e-5)
    assert layer.weight.dtype == torch.float32
    assert torch.equal(layer.bias, torch.zeros(out_features))
    x = np.random.RandomState(1).randn(5, in_features).astype(np.float32)
    for jdtype, dtype, tol in ((jnp.float32, torch.float32, 1e-6),
            (jnp.bfloat16, torch.bfloat16, 1e-2)):
        dense = jax_layer_init_dense(out_features, std, dtype=jdtype)
        params = jax.tree.map(np.asarray, dense.init(jax.random.PRNGKey(2),
            jnp.asarray(x)))
        want = np.asarray(dense.apply(params, jnp.asarray(x)), np.float32)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(params['params'][
                'kernel'].T.copy()))
            layer.bias.copy_(torch.from_numpy(np.array(
                params['params']['bias'])))
            got = _linear(layer, torch.from_numpy(x), dtype).float()
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_orthogonal_init_is_an_initialiser():
    init = orthogonal_init(0.5)
    t = torch.empty(4, 9)
    assert init(t, torch.Generator().manual_seed(0)) is t
    np.testing.assert_allclose((t.double() @ t.double().T).numpy(),
        0.25 * np.eye(4), atol=1e-6)
    again = orthogonal_init(0.5)(torch.empty(4, 9),
        torch.Generator().manual_seed(0))
    assert torch.equal(t, again)
    # the default gain is sqrt 2, as the JAX orthogonal_init's
    t = orthogonal_init()(torch.empty(3, 3))
    np.testing.assert_allclose((t.double() @ t.double().T).numpy(),
        2 * np.eye(3), atol=1e-6)


def test_save_pytree_files_cross_between_packages(tmp_path):
    """A Default's params written by the JAX save_pytree load here, and
    convert.py makes of them a state_dict that computes the JAX forward;
    a tree written here (tensors, arrays, nesting) loads in JAX's
    load_pytree, every leaf a numpy array equal to what was saved."""
    jspace, space = jspaces.Discrete(5), spaces.Discrete(5)
    jmod = JaxDefault(obs_shape=(7, 7), action_space=jspace, hidden_size=16)
    obs = np.random.RandomState(0).randn(3, 7, 7).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    path = str(tmp_path / 'jax.ckpt')
    jax_checkpoint.save_pytree(params, path)
    tmod = Default(obs_shape=(7, 7), action_space=space, hidden_size=16)
    tmod.load_state_dict(default_state_dict(checkpoint.load_pytree(path)))
    want_logits, want_value = jmod.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        logits, value = tmod(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
        rtol=1e-6, atol=1e-6)

    tree = {'params': {k: v for k, v in tmod.state_dict().items()},
        'step': np.int64(7), 'nested': [torch.arange(3), (np.ones(2),)]}
    path = str(tmp_path / 'torch.ckpt')
    checkpoint.save_pytree(tree, path)
    assert not os.path.exists(path + '.tmp')
    back = jax_checkpoint.load_pytree(path)
    for k, v in tmod.state_dict().items():
        assert isinstance(back['params'][k], np.ndarray)
        assert np.array_equal(back['params'][k], v.numpy()), k
    assert back['step'] == 7
    assert np.array_equal(back['nested'][0], np.arange(3))
    assert isinstance(back['nested'][1], tuple)
    assert np.array_equal(back['nested'][1][0], np.ones(2))


def test_simple_demo_runs_on_the_cpu():
    proc = subprocess.run([sys.executable, 'simple_demo_torch.py'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PUFFER_DEVICE='cpu', OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith('score: ')
    assert math.isfinite(float(last.split()[-1]))


def _names(path, imported):
    """Public top-level names a module defines (functions, classes,
    assignments), and with `imported` also those it imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    if imported:
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                out |= {(a.asname or a.name).split('.')[0]
                    for a in node.names}
    return {n for n in out if not n.startswith('_')}


def test_public_names_match_the_jax_package():
    """Every public name each JAX module defines is bound at the top of
    its counterpart in the port (pallas kernels aside: ops/cuda holds
    theirs), but for ppo.suggest_minibatch_size."""
    jax_root = os.path.join(REPO, 'pufferlib_tpu')
    gaps = {}
    for root, _, files in os.walk(jax_root):
        rel = os.path.relpath(root, jax_root)
        if rel.startswith(os.path.join('ops', 'pallas')):
            continue
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(root, name)
            port = os.path.join(REPO, 'pufferlib_tpu_torch', rel, name)
            assert os.path.exists(port), port
            missing = _names(path, False) - _names(port, True)
            if missing:
                gaps[os.path.relpath(path, REPO)] = sorted(missing)
    assert gaps == {os.path.join('pufferlib_tpu', 'training', 'ppo.py'):
        ['suggest_minibatch_size']}
