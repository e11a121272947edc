"""Annealing / interpolation schedules (PyTorch port of
``odin_tpu/backend/interpolation.py``).

Every schedule maps a step count onto ``[vmin, vmax]`` through an easing
curve ``alpha: [0, 1] -> [0, 1]``, with optional cyclical repetition and
in/out delays.  A schedule is computed with tensor operations only: called
on a device tensor ``step`` it returns a device tensor without a sync with
the host, so that a beta schedule can live inside a captured CUDA graph.
Called on a Python number it returns a 0-d CPU tensor.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "Interpolation", "const", "linear", "smooth", "smooth2", "fade", "smoother",
    "power", "powerIn", "powerOut", "sine", "sineIn", "sineOut", "circle",
    "circleIn", "circleOut", "swing", "swingIn", "swingOut", "exp", "expIn",
    "expOut", "elastic", "elasticIn", "elasticOut", "get",
]


def _f32(step) -> torch.Tensor:
  return torch.as_tensor(step).to(torch.float32)


class Interpolation:
  """Map a step value into ``[vmin, vmax]`` through an easing curve.

  Args:
    vmin, vmax: output range.
    steps: normalization constant (cycle length when ``cyclical``).
    delay_in / delay_out: flat delay at the start / end of each cycle.
    cyclical: repeat the schedule every ``delay_in + steps + delay_out``.
  """

  def __init__(self, vmin: float = 0., vmax: float = 1., steps: float = 1,
               delay_in: float = 0, delay_out: float = 0, cyclical: bool = False):
    self.vmin = float(vmin)
    self.vmax = float(vmax)
    self.steps = float(steps)
    self.cyclical = bool(cyclical)
    self.delay_in = max(float(delay_in), 0.)
    self.delay_out = max(float(delay_out), 0.)

  @property
  def name(self) -> str:
    mode = "cyc" if self.cyclical else "lin"
    return (f"{type(self).__name__.lower()}_{self.vmin:g}_{self.vmax:g}_"
            f"{self.steps:g}_{self.delay_in:g}_{self.delay_out:g}_{mode}")

  @property
  def mean(self) -> float:
    return 0.5 * (self.vmin + self.vmax)

  def __repr__(self):
    return (f"<{type(self).__name__}({self.vmin:g},{self.vmax:g},{self.steps:g}) "
            f"cyclical:{self.cyclical} delay:({self.delay_in:g},{self.delay_out:g})>")

  def __call__(self, step) -> torch.Tensor:
    a = torch.clamp(_f32(step), min=1e-8)
    if self.cyclical:
      a = torch.remainder(a, self.delay_in + self.steps + self.delay_out) + 1.
      a = torch.clamp(a - self.delay_in, 0., self.steps)
    else:
      a = a - self.delay_in
    a = torch.clamp(a / self.steps, 0., 1.)
    return (self.vmax - self.vmin) * self._alpha(a) + self.vmin

  def _alpha(self, a: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError


class const(Interpolation):

  def __call__(self, step):
    return torch.full_like(_f32(step), self.vmax)


class linear(Interpolation):

  def _alpha(self, a):
    return a


class smooth(Interpolation):
  """Smoothstep."""

  def _alpha(self, a):
    return a * a * (3. - 2. * a)


class smooth2(smooth):
  pass


class fade(Interpolation):
  """Perlin smootherstep: 6a^5 - 15a^4 + 10a^3."""

  def _alpha(self, a):
    return a * a * a * (a * (6. * a - 15.) + 10.)


smoother = fade


class power(Interpolation):
  """Symmetric ease-in-out of a power curve."""

  def __init__(self, vmin=0., vmax=1., steps=1, cyclical=False,
               delay_in=0, delay_out=0, power=2., inverse=False):
    super().__init__(vmin, vmax, steps, delay_in, delay_out, cyclical)
    self.power = float(power)
    self.inverse = bool(inverse)

  def _alpha(self, a):
    p = self.power
    lo = torch.pow(a * 2., p) / 2.
    hi = torch.pow((a - 1.) * 2., p) / ((p % 2 - 0.5) * 4.) + 1.
    return torch.where(a <= 0.5, lo, hi)


class powerIn(power):

  def _alpha(self, a):
    p = 1. / self.power if self.inverse else self.power
    return torch.pow(a, p)


class powerOut(power):

  def _alpha(self, a):
    if self.inverse:
      return 1. - torch.pow(1. - a, 1. / self.power)
    p = self.power
    return torch.pow(a - 1., p) * (p % 2 - 0.5) * 2. + 1.


class sine(Interpolation):

  def _alpha(self, a):
    return (1. - torch.cos(a * math.pi)) / 2.


class sineIn(Interpolation):

  def _alpha(self, a):
    return 1. - torch.cos(a * math.pi / 2.)


class sineOut(Interpolation):

  def _alpha(self, a):
    return torch.sin(a * math.pi / 2.)


class circle(Interpolation):

  def _alpha(self, a):
    lo = (1. - torch.sqrt(torch.clamp(1. - (a * 2.) ** 2, min=0.))) / 2.
    hi = (torch.sqrt(torch.clamp(1. - ((a - 1.) * 2.) ** 2, min=0.)) + 1.) / 2.
    return torch.where(a <= 0.5, lo, hi)


class circleIn(Interpolation):

  def _alpha(self, a):
    return 1. - torch.sqrt(torch.clamp(1. - a * a, min=0.))


class circleOut(Interpolation):

  def _alpha(self, a):
    return torch.sqrt(torch.clamp(1. - (a - 1.) ** 2, min=0.))


class swing(Interpolation):
  """Back ease-in-out with overshoot `scale`."""

  def __init__(self, scale=3, vmin=0., vmax=1., steps=1, cyclical=False,
               delay_in=0, delay_out=0):
    super().__init__(vmin, vmax, steps, delay_in, delay_out, cyclical)
    self.scale = float(scale)

  def _alpha(self, a):
    s = self.scale
    lo = (a * 2.) ** 2 * ((s + 1.) * a * 2. - s) / 2.
    b = (a - 1.) * 2.
    hi = b * b * ((s + 1.) * b + s) / 2. + 1.
    return torch.where(a <= 0.5, lo, hi)


class swingIn(swing):

  def __init__(self, scale=2, **kwargs):
    super().__init__(scale=scale, **kwargs)

  def _alpha(self, a):
    s = self.scale
    return a * a * ((s + 1.) * a - s)


class swingOut(swingIn):

  def _alpha(self, a):
    s = self.scale
    b = a - 1.
    return b * b * ((s + 1.) * b + s) + 1.


class exp(Interpolation):
  """Exponential ease-in-out on base^power."""

  def __init__(self, vmin=0., vmax=1., steps=1, cyclical=False,
               delay_in=0, delay_out=0, base=2., power=5.):
    super().__init__(vmin, vmax, steps, delay_in, delay_out, cyclical)
    self.base = float(base)
    self.power = float(power)
    self.min_val = self.base ** (-self.power)
    self.scale = 1. / (1. - self.min_val)

  def _alpha(self, a):
    b, p, m, s = self.base, self.power, self.min_val, self.scale
    lo = (torch.pow(b, p * (a * 2. - 1.)) - m) * s / 2.
    hi = (2. - (torch.pow(b, -p * (a * 2. - 1.)) - m) * s) / 2.
    return torch.where(a <= 0.5, lo, hi)


class expIn(exp):

  def _alpha(self, a):
    return (torch.pow(self.base, self.power * (a - 1.)) - self.min_val) \
        * self.scale


class expOut(exp):

  def _alpha(self, a):
    return 1. - (torch.pow(self.base, -self.power * a) - self.min_val) \
        * self.scale


class elastic(Interpolation):

  def __init__(self, vmin=0., vmax=1., steps=1, cyclical=False,
               delay_in=0, delay_out=0, base=2., power=10., scale=1., bounces=7.):
    super().__init__(vmin, vmax, steps, delay_in, delay_out, cyclical)
    self.base = float(base)
    self.power = float(power)
    self.scale = float(scale)
    self.bounces = float(bounces) * math.pi * (1. if bounces % 2 == 0 else -1.)

  def _alpha(self, a):
    b, p, s, w = self.base, self.power, self.scale, self.bounces
    lo = torch.pow(b, p * (a * 2. - 1.)) * torch.sin(a * 2. * w) * s / 2.
    hi = 1. - torch.pow(b, p * ((1. - a) * 2. - 1.)) \
        * torch.sin((1. - a) * 2. * w) * s / 2.
    return torch.where(a <= 0.5, lo, hi)


class elasticIn(elastic):

  def _alpha(self, a):
    b, p, s, w = self.base, self.power, self.scale, self.bounces
    val = torch.pow(b, p * (a - 1.)) * torch.sin(a * w) * s
    return torch.where(a >= 0.99, torch.ones_like(a), val)


class elasticOut(elastic):

  def _alpha(self, a):
    b, p, s, w = self.base, self.power, self.scale, self.bounces
    val = 1. - torch.pow(b, p * (-a)) * torch.sin((1. - a) * w) * s
    return torch.where(a == 0., torch.zeros_like(a), val)


def get(name=None):
  """Look up an interpolation class by name (``get('linear')``)."""
  if name is None:
    return Interpolation
  if isinstance(name, Interpolation):
    return name
  name = str(name).lower().strip()
  table = {k.lower(): v for k, v in globals().items()
           if isinstance(v, type) and issubclass(v, Interpolation)}
  if name not in table:
    raise ValueError(f"unknown interpolation '{name}', available: {sorted(table)}")
  return table[name]
