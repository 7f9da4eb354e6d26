"""Media (image) logging: `*_map` infos -> wandb.Image (counterpart of
pufferlib_tpu/training/media.py, which the host trainer calls).

Parity: reference clean_pufferl.py:125-146 — during evaluate, the
pokemon exploration map is max-accumulated across envs and rendered as
a Kanto overlay (pokemon_red_eval.py:9-38); any other info key
containing '_map' is logged as a wandb Image of the first env's value.
The sink works with any object exposing `.Image` (the real wandb
module or a test fake).
"""
import numpy as np


#: cell-edge upscale factor from the counts grid to map pixels
_CELL = 16
#: visit counts saturate the heat scale here (hue hits pure red)
_HEAT_CAP = 1000.0
#: overlay opacity on visited cells
_ALPHA = 0.8


def _heat_rgb(heat):
    """Map heat in [0, 1] to a fully-saturated color ramp, blue (cold)
    through green to red (hot). Equivalent to walking hue from 2/3 down
    to 0 at s=v=1, computed directly with the triangular hue-wheel
    formula instead of a generic HSV conversion.

    Behavioral spec: reference pokemon_red_eval.py:14-38 (which routes
    through matplotlib hsv_to_rgb).
    """
    sixh = 4.0 * (1.0 - heat)  # 6*hue, hue = 2*(1-heat)/3
    r = np.clip(np.abs(sixh - 3.0) - 1.0, 0.0, 1.0)
    g = np.clip(2.0 - np.abs(sixh - 2.0), 0.0, 1.0)
    b = np.clip(2.0 - np.abs(sixh - 4.0), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def make_pokemon_red_overlay(bg, counts):
    """Render visit counts as a heat overlay on the Kanto map: each
    counts cell becomes a 16x16 pixel block; visited blocks composite
    their heat color onto the background at 80% opacity, unvisited
    pixels pass the background through unchanged.

    Behavioral spec: reference pokemon_red_eval.py:14-38.
    """
    counts = np.asarray(counts, dtype=np.float64)
    heat = np.minimum(counts, _HEAT_CAP) / _HEAT_CAP
    color = np.floor(255.0 * _heat_rgb(heat))  # uint8 quantization

    # Upscale per-cell values to pixel blocks along both grid axes.
    color = color.repeat(_CELL, axis=0).repeat(_CELL, axis=1)
    visited = (counts > 0).repeat(_CELL, axis=0).repeat(_CELL, axis=1)

    bg = np.asarray(bg)
    blended = (1.0 - _ALPHA) * bg.astype(np.float64) + _ALPHA * color
    out = np.where(visited[..., None], blended, bg)
    return np.clip(out, 0, 255).astype(np.uint8)


def map_updater(bg_path='kanto_map_dsv.png'):
    """Returns counts -> rendered overlay. Loads the background with
    cv2/PIL when available; falls back to a black background of the
    right (upscaled) size so the pipeline runs anywhere."""
    bg = None
    try:
        import cv2
        bg = cv2.imread(bg_path)
    except ImportError:
        try:
            from PIL import Image
            bg = np.asarray(Image.open(bg_path))
        except (ImportError, FileNotFoundError, OSError):
            bg = None

    def update(counts):
        counts = np.asarray(counts)
        background = bg
        if background is None:
            background = np.zeros(
                (counts.shape[0] * _CELL, counts.shape[1] * _CELL, 3),
                np.uint8)
        return make_pokemon_red_overlay(background, counts)

    return update


def collect_media_stats(infos, stats, wandb, data):
    """Route media infos into `stats` (reference clean_pufferl.py:125-146).

    infos: dict of key -> list of per-env values (host trainer) or
    key -> array (device trainer). Mutates `stats`; returns the set of
    keys consumed (so numeric aggregation skips them). `data` carries
    the persistent accumulator (`pokemon_map`, `map_updater`).

    NOTE (device trainer): the fused path accumulates infos by SUM over
    envs and steps on the device, so a `*_map` info coming
    through ppo._materialize_metrics carries summed counts — only
    idempotent / accumulator-style maps (e.g. visit counters, which the
    overlay clips anyway) render meaningfully there. The host trainer
    passes per-env values and matches the reference exactly
    (clean_pufferl.py:125-146).
    """
    consumed = set()
    if wandb is None:
        return consumed

    pmaps = infos.get('pokemon_exploration_map')
    if pmaps is not None:
        if not isinstance(pmaps, (list, tuple)):
            pmaps = [pmaps]
        for pmap in pmaps:
            if getattr(data, 'pokemon_map', None) is None:
                data.map_updater = map_updater()
                data.pokemon_map = np.asarray(pmap)
            data.pokemon_map = np.maximum(data.pokemon_map, pmap)
        if len(pmaps) > 0:
            rendered = data.map_updater(data.pokemon_map)
            stats['Media/exploration_map'] = wandb.Image(rendered)
        consumed.add('pokemon_exploration_map')

    for k, v in infos.items():
        if '_map' in k and k not in consumed:
            first = v[0] if isinstance(v, (list, tuple)) else v
            stats[f'Media/{k}'] = wandb.Image(np.asarray(first))
            consumed.add(k)
    return consumed
