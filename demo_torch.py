"""Command-line entry point of pufferlib_tpu_torch: train / eval / sweep /
autotune / profile / baseline / bench (counterpart of demo.py).

    python3 demo_torch.py --env squared
    python3 demo_torch.py --env memory --train.learning_rate 0.01
    python3 demo_torch.py --env squared --train.device cpu --train.num_envs 64
    python3 demo_torch.py --env squared --mode eval --model-path PATH.pt
    python3 demo_torch.py --env squared --mode autotune
    python3 demo_torch.py --mode bench

The config is config.yaml's, read by pufferlib_tpu_torch.config.cli; it
trains on the card (train.device 'tpu' or 'cuda') unless
--train.device cpu asks for the CPU. Device envs (Ocean) train through
the fused trainer, training.ppo; host envs (gymnasium / pettingzoo
creators) through vector_host and training.ppo_host.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def init_wandb(args, resume=True):
    import wandb
    wandb.init(
        id=args.exp_id or wandb.util.generate_id(),
        project=args.wandb_project,
        group=args.wandb_group,
        allow_val_change=True,
        save_code=True,
        resume=resume,
        config={
            'train': dict(args.train),
            'env': dict(args.env_kwargs),
            'policy': dict(args.policy),
        },
    )
    return wandb


def _is_host_creator(creator, env_kwargs):
    """True when the creator yields a host (CPU) env, which trains
    through vector_host + ppo_host, rather than a batched device env. The
    probe of a device env is its description: an Ocean env object holds
    no tensor until its lanes are reset on a device."""
    from pufferlib_tpu_torch.host_env import (
        GymnasiumPufferEnv, PettingZooPufferEnv)
    probe = creator(**env_kwargs)
    is_host = isinstance(probe, (GymnasiumPufferEnv, PettingZooPufferEnv))
    if hasattr(probe, 'close'):
        probe.close()
    return is_host


def _device(args):
    return args.train.get('device', 'cuda')


def make_vecenv(args, creator, backend_name=None, num_envs=None):
    env_kwargs = dict(args.env_kwargs)
    num_envs = num_envs or args.train.num_envs
    name = backend_name or args.vec
    if _is_host_creator(creator, env_kwargs):
        import pufferlib_tpu_torch.vector_host as vector_host
        backend = {
            'device': vector_host.HostMultiprocessing,
            'serial': vector_host.HostSerial,
            'multiprocessing': vector_host.HostMultiprocessing,
        }[name]
        kwargs = {}
        if backend is vector_host.HostMultiprocessing:
            kwargs = dict(
                num_workers=args.train.get('num_workers') or num_envs,
                batch_size=args.train.get('env_batch_size'),
                restart_workers=args.train.get('restart_workers', 0))
        return vector_host.make(creator, env_kwargs=env_kwargs,
            backend=backend, num_envs=num_envs, **kwargs)
    import pufferlib_tpu_torch.vector as vector
    backend = {
        'device': vector.Device,
        'serial': vector.Serial,
        'multiprocessing': vector.Device,
    }[name]
    return vector.make(creator, env_kwargs=env_kwargs, backend=backend,
        num_envs=num_envs, device=_device(args))


def _is_host_vecenv(vecenv):
    import pufferlib_tpu_torch.vector_host as vector_host
    return isinstance(vecenv, (vector_host.HostSerial,
        vector_host.HostMultiprocessing, vector_host.HostRay))


def train(args, env_module, creator):
    from pufferlib_tpu_torch.config.cli import make_policy
    from pufferlib_tpu_torch.training import checkpoint as ckpt
    from pufferlib_tpu_torch.training import ppo as ppo_device
    from pufferlib_tpu_torch.training import ppo_host
    from pufferlib_tpu_torch.training.dashboard import (
        Utilization, make_dashboard_hook)

    wandb = init_wandb(args) if args.track else None
    vecenv = make_vecenv(args, creator)
    policy = make_policy(vecenv, env_module, args)
    host = _is_host_vecenv(vecenv)
    ppo = ppo_host if host else ppo_device

    train_cfg = dict(args.train)
    for k in ('num_envs', 'num_workers', 'env_batch_size',
            'restart_workers'):
        train_cfg.pop(k, None)
    config = ppo.default_config(env=args.env, exp_id=args.exp_id,
        **train_cfg)
    data = ppo.create(config, vecenv, policy, wandb=wandb)
    data.utilization = Utilization(device=data.device)
    if config.verbose and sys.stdout.isatty():
        data.dashboard = make_dashboard_hook()
    if args.exp_id:
        ckpt.try_load_checkpoint(data)

    try:
        while data.global_step < config.total_timesteps:
            if host:
                ppo.evaluate(data)
                ppo.train(data)
            else:
                # one epoch of rollout, GAE and update on the device; the
                # metrics are read at the dashboard interval
                ppo.step(data)
    except KeyboardInterrupt:
        print('\nInterrupted; saving checkpoint')
        ckpt.save_checkpoint(data)
    finally:
        data.utilization.stop()
        ppo.close(data)
    return data


def _render_frame(vecenv):
    """One frame from either engine: a device Serial renders its first
    lane's state (`env.render(state)`), host backends their driver env
    (an ansi str or an rgb array)."""
    env = getattr(vecenv, 'env', None)
    if env is not None and hasattr(env, 'render') \
            and getattr(vecenv, '_states', None):
        try:
            return env.render(vecenv._states[0])
        except NotImplementedError:
            return None
    driver = getattr(vecenv, 'driver_env', None)
    if driver is not None and hasattr(driver, 'render'):
        try:
            return driver.render()
        except Exception:
            return None
    return None


def _show_frame(frame, step, save_dir=None):
    """Ansi strings to the terminal; rgb arrays through cv2 where it can
    show them, else saved under save_dir (reference
    clean_pufferl.py:571-594)."""
    if frame is None:
        return
    if isinstance(frame, str):
        print('\033[0;0H' + frame + '\n')
        return
    frame = np.asarray(frame)
    try:
        # cv2.imshow raises cv2.error, not ImportError, on a host without
        # a display: any failure falls back to saving the frame
        import cv2
        cv2.imshow('frame', frame[..., ::-1] if frame.ndim == 3 else frame)
        cv2.waitKey(1)
    except Exception:
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            try:
                from PIL import Image
                Image.fromarray(frame).save(
                    os.path.join(save_dir, f'frame_{step:06d}.png'))
            except ImportError:
                np.save(os.path.join(save_dir, f'frame_{step:06d}.npy'),
                    frame)


def load_model(policy, path, device):
    """Load the port's own model_*.pt (a state_dict of this policy). Any
    other file, a reference PufferLib checkpoint among them, raises."""
    import pickle
    import torch
    from pufferlib_tpu_torch.exceptions import APIUsageError
    refusal = (f'{path} is not a pufferlib_tpu_torch model_*.pt state_dict '
        'of this policy; loading a reference PufferLib checkpoint is '
        'ROADMAP queue 1 item 6 (frameworks)')
    try:
        state = torch.load(path, map_location=device, weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        # a pickled module, or not a torch file at all
        raise APIUsageError(refusal) from e
    if not isinstance(state, dict) or set(state) != set(policy.state_dict()):
        raise APIUsageError(refusal)
    policy.load_state_dict(state)


def evaluate(args, env_module, creator):
    """Render a rollout of a (trained) policy, one env (reference
    clean_pufferl.py:551-594), device or host; rgb frames through cv2
    where it can show them, else into PUFFER_FRAME_DIR.
    PUFFER_EVAL_STEPS / PUFFER_EVAL_DELAY bound the steps and pace
    them."""
    import torch
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.config.cli import make_policy
    from pufferlib_tpu_torch.models import RecurrentPolicy

    device = resolve_device(_device(args))
    vecenv = make_vecenv(args, creator, backend_name='serial', num_envs=1)
    policy = make_policy(vecenv, env_module, args).to(device)
    if args.model_path:
        load_model(policy, args.model_path, device)
    recurrent = isinstance(policy, RecurrentPolicy)
    state = policy.initial_state(vecenv.num_agents, device=device) \
        if recurrent else None
    generator = torch.Generator(device=device).manual_seed(0)

    obs, _ = vecenv.reset()
    frames = int(os.environ.get('PUFFER_EVAL_STEPS', 10 ** 9))
    delay = float(os.environ.get('PUFFER_EVAL_DELAY', 0.3))
    save_dir = os.environ.get('PUFFER_FRAME_DIR')
    for step in range(frames):
        _show_frame(_render_frame(vecenv), step, save_dir)
        x = torch.as_tensor(obs, device=device)
        with torch.no_grad():
            if recurrent:
                action, _, _, _, state = policy(x, state,
                    generator=generator)
            else:
                action, _, _, _ = policy(x, generator=generator)
        if _is_host_vecenv(vecenv):
            action = action.cpu().numpy()
        obs, reward = vecenv.step(action)[:2]
        print(f'Reward: {float(torch.as_tensor(reward).float().mean()):.4f}')
        time.sleep(delay)
    vecenv.close()


def _synchronize(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def autotune(args, env_module, creator, epochs=8):
    """The num_envs that maximises the fused trainer's steps/s, over a
    ladder of lane counts (the device analog of reference vector.autotune,
    vector.py:669-854, which tunes the host pool's workers and batch; host
    envs run that one). Each rung: one warm-up epoch, then `epochs`
    epochs between two synchronisations of the trainer's device. A rung
    that fails stops the ladder and is reported."""
    from pufferlib_tpu_torch.config.cli import make_policy
    from pufferlib_tpu_torch.training import ppo

    if _is_host_creator(creator, dict(args.env_kwargs)):
        import pufferlib_tpu_torch.vector_host as vector_host
        return vector_host.autotune(creator,
            env_kwargs=dict(args.env_kwargs),
            max_envs=args.train.get('num_envs') or 64)

    results = {}
    lanes = os.environ.get('PUFFER_AUTOTUNE_LANES')
    if lanes:
        ladder = [int(x) for x in lanes.split(',')]
    else:
        ladder = [512 * 4 ** i for i in range(5)]  # 512..131072
    horizon = int(os.environ.get('PUFFER_AUTOTUNE_HORIZON', 64))
    print(f'{"num_envs":>10} {"SPS":>14} {"ms/epoch":>10}')
    for n in ladder:
        try:
            vecenv = make_vecenv(args, creator, backend_name='device',
                num_envs=n)
            policy = make_policy(vecenv, env_module, args)
            batch = n * horizon
            train_cfg = dict(args.train)
            for k in ('num_envs', 'num_workers', 'env_batch_size',
                    'batch_size', 'minibatch_size', 'total_timesteps',
                    'bptt_horizon', 'verbose', 'data_dir',
                    'checkpoint_interval', 'anneal_lr'):
                train_cfg.pop(k, None)
            config = ppo.default_config(env=args.env, batch_size=batch,
                minibatch_size=batch // 4, bptt_horizon=16,
                total_timesteps=batch * 10 ** 6, anneal_lr=False,
                verbose=False, data_dir=os.path.join(tempfile.gettempdir(),
                    'puffer_autotune'),
                checkpoint_interval=10 ** 6, **train_cfg)
            data = ppo.create(config, vecenv, policy)
            ppo.step(data)
            _synchronize(data.device)
            start = time.perf_counter()
            for _ in range(epochs):
                ppo.step(data)
            _synchronize(data.device)
            dt = (time.perf_counter() - start) / epochs
            results[n] = batch / dt
            print(f'{n:>10} {results[n]:>14.0f} {dt * 1e3:>10.1f}')
            del data, policy, vecenv
        except Exception as e:
            print(f'{n:>10} failed: {e}')
            if not results:
                raise
            break
    best = max(results, key=results.get)
    print(f'Best: --train.num_envs {best} ({results[best]:.0f} SPS)')
    return results


def profile(args, env_module, creator):
    """cProfile over a short train (reference demo.py:278-284), and with
    PUFFER_TRACE_DIR set a torch.profiler Chrome trace of it there
    (trace.json: the card's kernels where the trainer runs on one)."""
    import cProfile
    import pstats
    args.train['total_timesteps'] = args.train['batch_size'] * 4
    trace_dir = os.environ.get('PUFFER_TRACE_DIR')
    if trace_dir:
        import torch.profiler
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if _device(args) != 'cpu':
            activities.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with cProfile.Profile() as pr:
                train(args, env_module, creator)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, 'trace.json')
        prof.export_chrome_trace(path)
        print(f'device trace written to {path}')
    else:
        with cProfile.Profile() as pr:
            train(args, env_module, creator)
    pstats.Stats(pr).sort_stats('cumulative').print_stats(10)


def sample_sweep_params(space, rng):
    """Draw one config from a sweep parameter space (config.yaml sweep
    sections; wandb-style distributions)."""
    out = {}
    for name, spec in space.items():
        dist = spec.get('distribution', 'uniform')
        if dist == 'log_uniform':
            lo, hi = np.log10(spec['min']), np.log10(spec['max'])
            out[name] = float(10 ** rng.uniform(lo, hi))
        elif dist == 'uniform':
            out[name] = float(rng.uniform(spec['min'], spec['max']))
        elif dist == 'int_uniform':
            out[name] = int(rng.randint(spec['min'], spec['max'] + 1))
        elif dist == 'categorical' or 'values' in spec:
            out[name] = spec['values'][rng.randint(len(spec['values']))]
        else:
            raise ValueError(f'Unknown distribution {dist} for {name}')
    return out


def sweep_objective(data, metric, mode='mean'):
    """A finished run's sweep objective: a statistic of the metric's
    series over the whole run (data.stats_history), not the noisy final
    epoch (reference demo.py:132-151). mode: 'mean', 'max' or 'final'.
    Where the series never saw the metric: the final stats' value, then
    episode_return."""
    series = [s[metric] for _, s in getattr(data, 'stats_history', [])
        if metric in s]
    if series and mode != 'final':
        return float(np.max(series) if mode == 'max' else np.mean(series))
    final = data.stats.get(metric, data.stats.get('episode_return', 0.0))
    return float(series[-1] if series else final)


def sweep(args, env_module, creator):
    """Hyperparameter sweep over config.yaml's sweep section: a wandb
    sweep with --track, else a local random search (reference
    demo.py:132-151)."""
    sweep_cfg = dict(args.sweep) if args.sweep else {}
    space = sweep_cfg.get('parameters', {
        'learning_rate': {'distribution': 'log_uniform',
            'min': 1e-4, 'max': 3e-2},
        'ent_coef': {'distribution': 'log_uniform',
            'min': 1e-3, 'max': 1e-1},
    })
    metric = sweep_cfg.get('metric', 'score')
    num_runs = int(sweep_cfg.get('num_runs', 10))

    if args.track:
        import wandb

        def to_wandb_spec(spec):
            dist = spec.get('distribution', 'uniform')
            if 'values' in spec:
                return {'values': spec['values']}
            return {'distribution': dist.replace('log_uniform',
                'log_uniform_values'), 'min': spec['min'],
                'max': spec['max']}

        sweep_id = wandb.sweep(sweep={
            'method': sweep_cfg.get('method', 'random'),
            'name': f'sweep-{args.env}',
            'metric': {'goal': 'maximize',
                'name': f'environment/{metric}'},
            'parameters': {k: to_wandb_spec(v) for k, v in space.items()},
        }, project=args.wandb_project)

        def run_once():
            # wandb.agent's boundary: a failed run is reported and the
            # agent goes on to the next
            try:
                wandb.init()
                for k, v in dict(wandb.config).items():
                    args.train[k] = v
                args.exp_id = None
                train(args, env_module, creator)
            except Exception:
                import traceback
                traceback.print_exc()

        wandb.agent(sweep_id, run_once, count=num_runs)
        return []

    rng = np.random.RandomState(0)
    results = []
    for i in range(num_runs):
        params = sample_sweep_params(space, rng)
        for k, v in params.items():
            args.train[k] = v
        args.train['verbose'] = False
        # the objective reads the run's stats series, which the fused
        # step materialises only for a sink that wants it
        args.train['track_history'] = True
        args.exp_id = None
        try:
            data = train(args, env_module, creator)
            score = sweep_objective(data, metric,
                mode=sweep_cfg.get('objective', 'mean'))
            results.append({**params, metric: float(score)})
            print(json.dumps(results[-1]))
        except Exception as e:
            print(f'run {i} failed: {e}')
    results.sort(key=lambda r: -r[metric])
    print('Best:', json.dumps(results[0]) if results else 'none')
    return results


def baseline(args, env_module, creator):
    """Download the experiment's latest wandb model artifact and evaluate
    it (reference demo.py:245-258)."""
    wandb = init_wandb(args, resume=False)
    artifact_name = f'{args.exp_id}_model:latest'
    artifact = wandb.run.use_artifact(artifact_name)
    data_dir = artifact.download()
    # model checkpoints only: trainer_state.pt is the optimizer's
    ckpts = sorted(f for f in os.listdir(data_dir)
        if f.startswith('model_'))
    if not ckpts:
        raise FileNotFoundError(f'no checkpoints in artifact {artifact_name}')
    args.model_path = os.path.join(data_dir, ckpts[-1])
    evaluate(args, env_module, creator)


def train_sb3(args, env_module, creator):
    """The SB3 backend (reference demo.py:203-218) waits for the
    frameworks bridge."""
    from pufferlib_tpu_torch.exceptions import APIUsageError
    raise APIUsageError('--backend sb3 needs the frameworks bridge, '
        'ROADMAP queue 1 item 6, which pufferlib_tpu_torch has not yet')


def bench():
    """bench_torch.py in a child process; its exit code is returned."""
    return subprocess.run([sys.executable,
        os.path.join(REPO, 'bench_torch.py')], cwd=REPO).returncode


def main(argv=None):
    from pufferlib_tpu_torch.config.cli import load_config
    args, env_module, creator = load_config(argv=argv)

    if args.mode == 'train' and args.backend == 'sb3':
        return train_sb3(args, env_module, creator)
    if args.mode == 'train':
        return train(args, env_module, creator)
    if args.mode == 'eval':
        return evaluate(args, env_module, creator)
    if args.mode == 'autotune':
        return autotune(args, env_module, creator)
    if args.mode == 'profile':
        return profile(args, env_module, creator)
    if args.mode == 'sweep':
        return sweep(args, env_module, creator)
    if args.mode == 'baseline':
        return baseline(args, env_module, creator)
    if args.mode == 'bench':
        rc = bench()
        if rc:
            raise SystemExit(rc)
        return rc


if __name__ == '__main__':
    main()
