"""paddle_tpu_torch._C_ops — generated op dispatch surface.

AUTO-GENERATED by paddle_tpu_torch/ops/yaml/generator.py from
paddle_tpu_torch/ops/yaml/ops.yaml — DO NOT EDIT BY HAND.

Reference analog: paddle._C_ops (python/paddle/_C_ops.py:20), the flat
namespace of generated Python-C bindings (python_c_gen.py:113). Each
binding resolves, on its first call, to the op library entry whose body is
torch ops dispatched through paddle_tpu_torch.core.dispatch.run_op (AMP,
autograd through torch's, NaN check).
"""
from __future__ import annotations

import importlib as _importlib

_cache = {}


def _bind(path):
    mod, fn = path.rsplit(".", 1)
    key = (mod, fn)
    if key not in _cache:
        _cache[key] = getattr(_importlib.import_module(mod), fn)
    return _cache[key]


def abs(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.abs')(*args, **kwargs)

def acos(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.acos')(*args, **kwargs)

def acosh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.acosh')(*args, **kwargs)

def add(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.add')(*args, **kwargs)

def add_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.add_')(*args, **kwargs)

elementwise_add = add  # op_compat.yaml legacy name

def addmm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.addmm')(*args, **kwargs)

def all(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.all')(*args, **kwargs)

reduce_all = all  # op_compat.yaml legacy name

def allclose(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.allclose')(*args, **kwargs)

def amax(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.amax')(*args, **kwargs)

def amin(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.amin')(*args, **kwargs)

def angle(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.angle')(*args, **kwargs)

def any(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.any')(*args, **kwargs)

reduce_any = any  # op_compat.yaml legacy name

def asin(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.asin')(*args, **kwargs)

def asinh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.asinh')(*args, **kwargs)

def atan(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.atan')(*args, **kwargs)

def atan2(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.atan2')(*args, **kwargs)

def atanh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.atanh')(*args, **kwargs)

def ceil(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.ceil')(*args, **kwargs)

def clip(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.clip')(*args, **kwargs)

def clip_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.clip_')(*args, **kwargs)

def conj(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.conj')(*args, **kwargs)

def copysign(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.copysign')(*args, **kwargs)

def cos(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.cos')(*args, **kwargs)

def cosh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.cosh')(*args, **kwargs)

def count_nonzero(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.count_nonzero')(*args, **kwargs)

def cummax(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.cummax')(*args, **kwargs)

def cummin(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.cummin')(*args, **kwargs)

def cumprod(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.cumprod')(*args, **kwargs)

def cumsum(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.cumsum')(*args, **kwargs)

def deg2rad(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.deg2rad')(*args, **kwargs)

def diagonal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.diagonal')(*args, **kwargs)

def diff(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.diff')(*args, **kwargs)

def digamma(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.digamma')(*args, **kwargs)

def divide(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.divide')(*args, **kwargs)

def divide_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.divide_')(*args, **kwargs)

elementwise_div = divide  # op_compat.yaml legacy name

def equal_all(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.equal_all')(*args, **kwargs)

def erf(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.erf')(*args, **kwargs)

def erfinv(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.erfinv')(*args, **kwargs)

def exp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.exp')(*args, **kwargs)

def exp_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.exp_')(*args, **kwargs)

def expm1(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.expm1')(*args, **kwargs)

def floor(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.floor')(*args, **kwargs)

def floor_divide(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.floor_divide')(*args, **kwargs)

elementwise_floordiv = floor_divide  # op_compat.yaml legacy name

def floor_mod(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.floor_mod')(*args, **kwargs)

def fmax(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.fmax')(*args, **kwargs)

def fmin(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.fmin')(*args, **kwargs)

def fmod(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.fmod')(*args, **kwargs)

def frac(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.frac')(*args, **kwargs)

def gcd(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.gcd')(*args, **kwargs)

def heaviside(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.heaviside')(*args, **kwargs)

def hypot(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.hypot')(*args, **kwargs)

def i0(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.i0')(*args, **kwargs)

def i0e(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.i0e')(*args, **kwargs)

def i1(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.i1')(*args, **kwargs)

def i1e(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.i1e')(*args, **kwargs)

def imag(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.imag')(*args, **kwargs)

def increment(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.increment')(*args, **kwargs)

def inner(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.inner')(*args, **kwargs)

def isclose(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isclose')(*args, **kwargs)

def isfinite(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isfinite')(*args, **kwargs)

def isinf(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isinf')(*args, **kwargs)

def isnan(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isnan')(*args, **kwargs)

def isneginf(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isneginf')(*args, **kwargs)

def isposinf(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isposinf')(*args, **kwargs)

def isreal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.isreal')(*args, **kwargs)

def kron(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.kron')(*args, **kwargs)

def lcm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.lcm')(*args, **kwargs)

def lerp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.lerp')(*args, **kwargs)

def lgamma(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.lgamma')(*args, **kwargs)

def log(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.log')(*args, **kwargs)

def log10(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.log10')(*args, **kwargs)

def log1p(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.log1p')(*args, **kwargs)

def log2(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.log2')(*args, **kwargs)

def logaddexp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.logaddexp')(*args, **kwargs)

def logcumsumexp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.logcumsumexp')(*args, **kwargs)

def logit(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.logit')(*args, **kwargs)

def logsumexp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.logsumexp')(*args, **kwargs)

def max(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.max')(*args, **kwargs)

reduce_max = max  # op_compat.yaml legacy name

def maximum(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.maximum')(*args, **kwargs)

elementwise_max = maximum  # op_compat.yaml legacy name

def mean(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.mean')(*args, **kwargs)

reduce_mean = mean  # op_compat.yaml legacy name

def min(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.min')(*args, **kwargs)

reduce_min = min  # op_compat.yaml legacy name

def minimum(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.minimum')(*args, **kwargs)

elementwise_min = minimum  # op_compat.yaml legacy name

def mod(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.mod')(*args, **kwargs)

def multiplex(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.multiplex')(*args, **kwargs)

def multiply(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.multiply')(*args, **kwargs)

def multiply_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.multiply_')(*args, **kwargs)

elementwise_mul = multiply  # op_compat.yaml legacy name

def nan_to_num(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.nan_to_num')(*args, **kwargs)

def nanmean(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.nanmean')(*args, **kwargs)

def nansum(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.nansum')(*args, **kwargs)

def neg(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.neg')(*args, **kwargs)

def nextafter(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.nextafter')(*args, **kwargs)

def outer(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.outer')(*args, **kwargs)

def pow(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.pow')(*args, **kwargs)

elementwise_pow = pow  # op_compat.yaml legacy name

def prod(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.prod')(*args, **kwargs)

reduce_prod = prod  # op_compat.yaml legacy name

def rad2deg(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.rad2deg')(*args, **kwargs)

def real(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.real')(*args, **kwargs)

def reciprocal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.reciprocal')(*args, **kwargs)

def remainder(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.remainder')(*args, **kwargs)

elementwise_mod = remainder  # op_compat.yaml legacy name

def round(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.round')(*args, **kwargs)

def rsqrt(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.rsqrt')(*args, **kwargs)

def scale(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.scale')(*args, **kwargs)

def scale_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.scale_')(*args, **kwargs)

def sigmoid(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sigmoid')(*args, **kwargs)

def sign(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sign')(*args, **kwargs)

def sin(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sin')(*args, **kwargs)

def sinh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sinh')(*args, **kwargs)

def sqrt(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sqrt')(*args, **kwargs)

def sqrt_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sqrt_')(*args, **kwargs)

def square(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.square')(*args, **kwargs)

def stanh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.stanh')(*args, **kwargs)

def std(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.std')(*args, **kwargs)

def subtract(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.subtract')(*args, **kwargs)

def subtract_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.subtract_')(*args, **kwargs)

elementwise_sub = subtract  # op_compat.yaml legacy name

def sum(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.sum')(*args, **kwargs)

reduce_sum = sum  # op_compat.yaml legacy name

def tan(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.tan')(*args, **kwargs)

def tanh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.tanh')(*args, **kwargs)

def trace(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.trace')(*args, **kwargs)

def trunc(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.trunc')(*args, **kwargs)

def var(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.math.var')(*args, **kwargs)

def as_complex(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.as_complex')(*args, **kwargs)

def as_real(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.as_real')(*args, **kwargs)

def atleast_1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.atleast_1d')(*args, **kwargs)

def atleast_2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.atleast_2d')(*args, **kwargs)

def atleast_3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.atleast_3d')(*args, **kwargs)

def broadcast_tensors(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.broadcast_tensors')(*args, **kwargs)

def broadcast_to(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.broadcast_to')(*args, **kwargs)

def cast(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.cast')(*args, **kwargs)

def cast_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.cast_')(*args, **kwargs)

def chunk(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.chunk')(*args, **kwargs)

def concat(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.concat')(*args, **kwargs)

concat_v2 = concat  # op_compat.yaml legacy name

def crop(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.crop')(*args, **kwargs)

def dstack(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.dstack')(*args, **kwargs)

def expand(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.expand')(*args, **kwargs)

def expand_as(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.expand_as')(*args, **kwargs)

def flatten(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.flatten')(*args, **kwargs)

def flatten_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.flatten_')(*args, **kwargs)

def flip(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.flip')(*args, **kwargs)

def gather(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.gather')(*args, **kwargs)

def gather_nd(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.gather_nd')(*args, **kwargs)

def hstack(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.hstack')(*args, **kwargs)

def index_add(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.index_add')(*args, **kwargs)

def index_fill(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.index_fill')(*args, **kwargs)

def index_put(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.index_put')(*args, **kwargs)

def index_sample(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.index_sample')(*args, **kwargs)

def index_select(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.index_select')(*args, **kwargs)

def masked_fill(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.masked_fill')(*args, **kwargs)

def masked_fill_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.masked_fill_')(*args, **kwargs)

def masked_scatter(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.masked_scatter')(*args, **kwargs)

def masked_select(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.masked_select')(*args, **kwargs)

def moveaxis(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.moveaxis')(*args, **kwargs)

def numel(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.numel')(*args, **kwargs)

def pad(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.pad')(*args, **kwargs)

def put_along_axis(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.put_along_axis')(*args, **kwargs)

def repeat_interleave(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.repeat_interleave')(*args, **kwargs)

def reshape(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.reshape')(*args, **kwargs)

def reshape_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.reshape_')(*args, **kwargs)

reshape2 = reshape  # op_compat.yaml legacy name

def roll(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.roll')(*args, **kwargs)

def rot90(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.rot90')(*args, **kwargs)

def scatter(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.scatter')(*args, **kwargs)

def scatter_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.scatter_')(*args, **kwargs)

def scatter_nd(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.scatter_nd')(*args, **kwargs)

def scatter_nd_add(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.scatter_nd_add')(*args, **kwargs)

def shard_index(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.shard_index')(*args, **kwargs)

def slice(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.slice')(*args, **kwargs)

def split(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.split')(*args, **kwargs)

def squeeze(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.squeeze')(*args, **kwargs)

def squeeze_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.squeeze_')(*args, **kwargs)

squeeze2 = squeeze  # op_compat.yaml legacy name

def stack(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.stack')(*args, **kwargs)

def strided_slice(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.strided_slice')(*args, **kwargs)

def swapaxes(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.swapaxes')(*args, **kwargs)

def t(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.t')(*args, **kwargs)

def take(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.take')(*args, **kwargs)

def take_along_axis(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.take_along_axis')(*args, **kwargs)

def tensor_split(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.tensor_split')(*args, **kwargs)

def tensordot(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.tensordot')(*args, **kwargs)

def tile(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.tile')(*args, **kwargs)

def transpose(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.transpose')(*args, **kwargs)

transpose2 = transpose  # op_compat.yaml legacy name

def unbind(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.unbind')(*args, **kwargs)

def unfold(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.unfold')(*args, **kwargs)

def unsqueeze(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.unsqueeze')(*args, **kwargs)

def unsqueeze_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.unsqueeze_')(*args, **kwargs)

unsqueeze2 = unsqueeze  # op_compat.yaml legacy name

def unstack(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.unstack')(*args, **kwargs)

def view(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.view')(*args, **kwargs)

def view_as(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.view_as')(*args, **kwargs)

def vstack(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.vstack')(*args, **kwargs)

def where(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.where')(*args, **kwargs)

def where_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.manipulation.where_')(*args, **kwargs)

def arange(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.arange')(*args, **kwargs)

range = arange  # op_compat.yaml legacy name

def assign(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.assign')(*args, **kwargs)

def clone(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.clone')(*args, **kwargs)

def complex(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.complex')(*args, **kwargs)

def diag(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.diag')(*args, **kwargs)

def diag_embed(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.diag_embed')(*args, **kwargs)

def diagflat(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.diagflat')(*args, **kwargs)

def empty(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.empty')(*args, **kwargs)

def empty_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.empty_like')(*args, **kwargs)

def eye(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.eye')(*args, **kwargs)

def full(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.full')(*args, **kwargs)

fill_constant = full  # op_compat.yaml legacy name

def full_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.full_like')(*args, **kwargs)

def linspace(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.linspace')(*args, **kwargs)

def logspace(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.logspace')(*args, **kwargs)

def meshgrid(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.meshgrid')(*args, **kwargs)

def one_hot(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.one_hot')(*args, **kwargs)

one_hot_v2 = one_hot  # op_compat.yaml legacy name

def ones(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.ones')(*args, **kwargs)

def ones_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.ones_like')(*args, **kwargs)

def polar(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.polar')(*args, **kwargs)

def to_tensor(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.to_tensor')(*args, **kwargs)

def tril(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.tril')(*args, **kwargs)

def tril_indices(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.tril_indices')(*args, **kwargs)

def triu(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.triu')(*args, **kwargs)

def triu_indices(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.triu_indices')(*args, **kwargs)

def zeros(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.zeros')(*args, **kwargs)

def zeros_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.creation.zeros_like')(*args, **kwargs)

def bitwise_and(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.bitwise_and')(*args, **kwargs)

def bitwise_left_shift(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.bitwise_left_shift')(*args, **kwargs)

def bitwise_not(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.bitwise_not')(*args, **kwargs)

def bitwise_or(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.bitwise_or')(*args, **kwargs)

def bitwise_right_shift(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.bitwise_right_shift')(*args, **kwargs)

def bitwise_xor(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.bitwise_xor')(*args, **kwargs)

def equal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.equal')(*args, **kwargs)

def greater_equal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.greater_equal')(*args, **kwargs)

def greater_than(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.greater_than')(*args, **kwargs)

def is_empty(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.is_empty')(*args, **kwargs)

def is_tensor(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.is_tensor')(*args, **kwargs)

def less_equal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.less_equal')(*args, **kwargs)

def less_than(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.less_than')(*args, **kwargs)

def logical_and(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.logical_and')(*args, **kwargs)

def logical_not(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.logical_not')(*args, **kwargs)

def logical_or(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.logical_or')(*args, **kwargs)

def logical_xor(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.logical_xor')(*args, **kwargs)

def not_equal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.logic.not_equal')(*args, **kwargs)

def argmax(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.argmax')(*args, **kwargs)

arg_max = argmax  # op_compat.yaml legacy name

def argmin(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.argmin')(*args, **kwargs)

arg_min = argmin  # op_compat.yaml legacy name

def argsort(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.argsort')(*args, **kwargs)

def bincount(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.bincount')(*args, **kwargs)

def bucketize(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.bucketize')(*args, **kwargs)

def histogram(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.histogram')(*args, **kwargs)

def histogramdd(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.histogramdd')(*args, **kwargs)

def kthvalue(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.kthvalue')(*args, **kwargs)

def median(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.median')(*args, **kwargs)

def mode(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.mode')(*args, **kwargs)

def nanmedian(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.nanmedian')(*args, **kwargs)

def nanquantile(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.nanquantile')(*args, **kwargs)

def nonzero(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.nonzero')(*args, **kwargs)

def quantile(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.quantile')(*args, **kwargs)

def searchsorted(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.searchsorted')(*args, **kwargs)

def sort(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.sort')(*args, **kwargs)

def topk(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.topk')(*args, **kwargs)

top_k_v2 = topk  # op_compat.yaml legacy name

def unique(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.unique')(*args, **kwargs)

def unique_consecutive(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.search.unique_consecutive')(*args, **kwargs)

def bmm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.bmm')(*args, **kwargs)

def cdist(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cdist')(*args, **kwargs)

def cholesky(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cholesky')(*args, **kwargs)

def cholesky_inverse(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cholesky_inverse')(*args, **kwargs)

def cholesky_solve(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cholesky_solve')(*args, **kwargs)

def cond(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cond')(*args, **kwargs)

def corrcoef(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.corrcoef')(*args, **kwargs)

def cov(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cov')(*args, **kwargs)

def cross(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.cross')(*args, **kwargs)

def det(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.det')(*args, **kwargs)

def dist(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.dist')(*args, **kwargs)

def dot(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.dot')(*args, **kwargs)

def eig(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.eig')(*args, **kwargs)

def eigh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.eigh')(*args, **kwargs)

def eigvals(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.eigvals')(*args, **kwargs)

def eigvalsh(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.eigvalsh')(*args, **kwargs)

def einsum(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.einsum')(*args, **kwargs)

def householder_product(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.householder_product')(*args, **kwargs)

def inv(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.inv')(*args, **kwargs)

def inverse(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.inverse')(*args, **kwargs)

def lstsq(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.lstsq')(*args, **kwargs)

def lu(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.lu')(*args, **kwargs)

def lu_unpack(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.lu_unpack')(*args, **kwargs)

def matmul(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.matmul')(*args, **kwargs)

matmul_v2 = matmul  # op_compat.yaml legacy name

def matrix_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.matrix_norm')(*args, **kwargs)

def matrix_power(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.matrix_power')(*args, **kwargs)

def matrix_rank(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.matrix_rank')(*args, **kwargs)

def mm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.mm')(*args, **kwargs)

def multi_dot(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.multi_dot')(*args, **kwargs)

def mv(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.mv')(*args, **kwargs)

def norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.norm')(*args, **kwargs)

def ormqr(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.ormqr')(*args, **kwargs)

def pca_lowrank(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.pca_lowrank')(*args, **kwargs)

def pinv(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.pinv')(*args, **kwargs)

def qr(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.qr')(*args, **kwargs)

def slogdet(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.slogdet')(*args, **kwargs)

def solve(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.solve')(*args, **kwargs)

def svd(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.svd')(*args, **kwargs)

def svd_lowrank(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.svd_lowrank')(*args, **kwargs)

def triangular_solve(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.triangular_solve')(*args, **kwargs)

def vector_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.linalg.vector_norm')(*args, **kwargs)

def bernoulli(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.bernoulli')(*args, **kwargs)

def bernoulli_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.bernoulli_')(*args, **kwargs)

def binomial(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.binomial')(*args, **kwargs)

def gaussian(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.gaussian')(*args, **kwargs)

def laplace(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.laplace')(*args, **kwargs)

def multinomial(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.multinomial')(*args, **kwargs)

def normal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.normal')(*args, **kwargs)

def normal_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.normal_')(*args, **kwargs)

def poisson(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.poisson')(*args, **kwargs)

def rand(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.rand')(*args, **kwargs)

def rand_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.rand_like')(*args, **kwargs)

def randint(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.randint')(*args, **kwargs)

def randint_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.randint_like')(*args, **kwargs)

def randn(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.randn')(*args, **kwargs)

def randn_like(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.randn_like')(*args, **kwargs)

def randperm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.randperm')(*args, **kwargs)

def standard_normal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.standard_normal')(*args, **kwargs)

def uniform(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.uniform')(*args, **kwargs)

def uniform_(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.random.uniform_')(*args, **kwargs)

def celu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.celu')(*args, **kwargs)

def elu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.elu')(*args, **kwargs)

def elu_(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.elu_')(*args, **kwargs)

def gelu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.gelu')(*args, **kwargs)

def glu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.glu')(*args, **kwargs)

def gumbel_softmax(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.gumbel_softmax')(*args, **kwargs)

def hardshrink(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.hardshrink')(*args, **kwargs)

def hardsigmoid(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.hardsigmoid')(*args, **kwargs)

def hardswish(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.hardswish')(*args, **kwargs)

def hardtanh(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.hardtanh')(*args, **kwargs)

def leaky_relu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.leaky_relu')(*args, **kwargs)

def log_sigmoid(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.log_sigmoid')(*args, **kwargs)

def log_softmax(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.log_softmax')(*args, **kwargs)

def maxout(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.maxout')(*args, **kwargs)

def mish(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.mish')(*args, **kwargs)

def prelu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.prelu')(*args, **kwargs)

def relu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.relu')(*args, **kwargs)

def relu_(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.relu_')(*args, **kwargs)

def relu6(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.relu6')(*args, **kwargs)

def rrelu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.rrelu')(*args, **kwargs)

def selu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.selu')(*args, **kwargs)

def silu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.silu')(*args, **kwargs)

def softmax(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.softmax')(*args, **kwargs)

def softmax_(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.softmax_')(*args, **kwargs)

def softplus(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.softplus')(*args, **kwargs)

def softshrink(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.softshrink')(*args, **kwargs)

def softsign(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.softsign')(*args, **kwargs)

def swish(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.swish')(*args, **kwargs)

def tanhshrink(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.tanhshrink')(*args, **kwargs)

def thresholded_relu(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.activation.thresholded_relu')(*args, **kwargs)

def alpha_dropout(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.alpha_dropout')(*args, **kwargs)

def bilinear(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.bilinear')(*args, **kwargs)

def channel_shuffle(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.channel_shuffle')(*args, **kwargs)

def cosine_similarity(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.cosine_similarity')(*args, **kwargs)

def dropout(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.dropout')(*args, **kwargs)

def dropout2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.dropout2d')(*args, **kwargs)

def dropout3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.dropout3d')(*args, **kwargs)

def embedding(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.embedding')(*args, **kwargs)

lookup_table_v2 = embedding  # op_compat.yaml legacy name

def fold(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.fold')(*args, **kwargs)

def interpolate(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.interpolate')(*args, **kwargs)

def label_smooth(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.label_smooth')(*args, **kwargs)

def linear(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.linear')(*args, **kwargs)

def normalize(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.normalize')(*args, **kwargs)

def pixel_shuffle(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.pixel_shuffle')(*args, **kwargs)

def pixel_unshuffle(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.pixel_unshuffle')(*args, **kwargs)

def sequence_mask(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.sequence_mask')(*args, **kwargs)

def upsample(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.common.upsample')(*args, **kwargs)

def conv1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.conv.conv1d')(*args, **kwargs)

def conv1d_transpose(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.conv.conv1d_transpose')(*args, **kwargs)

def conv2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.conv.conv2d')(*args, **kwargs)

def conv2d_transpose(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.conv.conv2d_transpose')(*args, **kwargs)

def conv3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.conv.conv3d')(*args, **kwargs)

def conv3d_transpose(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.conv.conv3d_transpose')(*args, **kwargs)

def binary_cross_entropy(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.binary_cross_entropy')(*args, **kwargs)

def binary_cross_entropy_with_logits(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.binary_cross_entropy_with_logits')(*args, **kwargs)

def cosine_embedding_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.cosine_embedding_loss')(*args, **kwargs)

def cross_entropy(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.cross_entropy')(*args, **kwargs)

def ctc_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.ctc_loss')(*args, **kwargs)

def dice_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.dice_loss')(*args, **kwargs)

def hinge_embedding_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.hinge_embedding_loss')(*args, **kwargs)

def huber_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.huber_loss')(*args, **kwargs)

def kl_div(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.kl_div')(*args, **kwargs)

def l1_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.l1_loss')(*args, **kwargs)

def log_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.log_loss')(*args, **kwargs)

def margin_ranking_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.margin_ranking_loss')(*args, **kwargs)

def mse_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.mse_loss')(*args, **kwargs)

def multi_label_soft_margin_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.multi_label_soft_margin_loss')(*args, **kwargs)

def nll_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.nll_loss')(*args, **kwargs)

def npair_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.npair_loss')(*args, **kwargs)

def sigmoid_focal_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.sigmoid_focal_loss')(*args, **kwargs)

def smooth_l1_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.smooth_l1_loss')(*args, **kwargs)

def soft_margin_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.soft_margin_loss')(*args, **kwargs)

def softmax_with_cross_entropy(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.softmax_with_cross_entropy')(*args, **kwargs)

def square_error_cost(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.square_error_cost')(*args, **kwargs)

def triplet_margin_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.loss.triplet_margin_loss')(*args, **kwargs)

def batch_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.norm.batch_norm')(*args, **kwargs)

def group_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.norm.group_norm')(*args, **kwargs)

def instance_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.norm.instance_norm')(*args, **kwargs)

def layer_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.norm.layer_norm')(*args, **kwargs)

def local_response_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.norm.local_response_norm')(*args, **kwargs)

def rms_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.norm.rms_norm')(*args, **kwargs)

def adaptive_avg_pool1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.adaptive_avg_pool1d')(*args, **kwargs)

def adaptive_avg_pool2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.adaptive_avg_pool2d')(*args, **kwargs)

def adaptive_avg_pool3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.adaptive_avg_pool3d')(*args, **kwargs)

def adaptive_max_pool1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.adaptive_max_pool1d')(*args, **kwargs)

def adaptive_max_pool2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.adaptive_max_pool2d')(*args, **kwargs)

def adaptive_max_pool3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.adaptive_max_pool3d')(*args, **kwargs)

def avg_pool1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.avg_pool1d')(*args, **kwargs)

def avg_pool2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.avg_pool2d')(*args, **kwargs)

def avg_pool3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.avg_pool3d')(*args, **kwargs)

def lp_pool1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.lp_pool1d')(*args, **kwargs)

def lp_pool2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.lp_pool2d')(*args, **kwargs)

def max_pool1d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.max_pool1d')(*args, **kwargs)

def max_pool2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.max_pool2d')(*args, **kwargs)

def max_pool3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.nn.functional.pooling.max_pool3d')(*args, **kwargs)

def p_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.p_norm')(*args, **kwargs)

def frobenius_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.frobenius_norm')(*args, **kwargs)

def squared_l2_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.squared_l2_norm')(*args, **kwargs)

def clip_by_norm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.clip_by_norm')(*args, **kwargs)

def renorm(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.renorm')(*args, **kwargs)

def gammaln(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.gammaln')(*args, **kwargs)

def polygamma(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.polygamma')(*args, **kwargs)

def gammaincc(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.gammaincc')(*args, **kwargs)

def gammainc(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.gammainc')(*args, **kwargs)

def standard_gamma(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.standard_gamma')(*args, **kwargs)

def dirichlet(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.dirichlet')(*args, **kwargs)

def logsigmoid(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.logsigmoid')(*args, **kwargs)

def tanh_shrink(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.tanh_shrink')(*args, **kwargs)

def swiglu(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.swiglu')(*args, **kwargs)

def fill(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.fill')(*args, **kwargs)

def fill_diagonal(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.fill_diagonal')(*args, **kwargs)

def reverse(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.reverse')(*args, **kwargs)

def shape(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.shape')(*args, **kwargs)

def as_strided(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.as_strided')(*args, **kwargs)

def tensor_unfold(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.tensor_unfold')(*args, **kwargs)

def view_dtype(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.view_dtype')(*args, **kwargs)

def view_shape(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.view_shape')(*args, **kwargs)

def split_with_num(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.split_with_num')(*args, **kwargs)

def reduce_as(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.reduce_as')(*args, **kwargs)

def bce_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.bce_loss')(*args, **kwargs)

def hinge_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.hinge_loss')(*args, **kwargs)

def kldiv_loss(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.kldiv_loss')(*args, **kwargs)

def sigmoid_cross_entropy_with_logits(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.sigmoid_cross_entropy_with_logits')(*args, **kwargs)

def margin_cross_entropy(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.margin_cross_entropy')(*args, **kwargs)

def fused_softmax_mask(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.fused_softmax_mask')(*args, **kwargs)

def fused_softmax_mask_upper_triangle(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.fused_softmax_mask_upper_triangle')(*args, **kwargs)

def flash_attn(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.flash_attn')(*args, **kwargs)

def edit_distance(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.edit_distance')(*args, **kwargs)

def viterbi_decode(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.viterbi_decode')(*args, **kwargs)

def gather_tree(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.gather_tree')(*args, **kwargs)

def top_p_sampling(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.top_p_sampling')(*args, **kwargs)

def send_u_recv(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.send_u_recv')(*args, **kwargs)

def segment_pool(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.segment_pool')(*args, **kwargs)

def bilinear_interp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.bilinear_interp')(*args, **kwargs)

def nearest_interp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.nearest_interp')(*args, **kwargs)

def bicubic_interp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.bicubic_interp')(*args, **kwargs)

def linear_interp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.linear_interp')(*args, **kwargs)

def trilinear_interp(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.trilinear_interp')(*args, **kwargs)

def affine_grid(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.affine_grid')(*args, **kwargs)

def grid_sample(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.grid_sample')(*args, **kwargs)

def pad3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.pad3d')(*args, **kwargs)

def pool2d(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.pool2d')(*args, **kwargs)

def pool3d(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.pool3d')(*args, **kwargs)

def max_pool2d_with_index(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.max_pool2d_with_index')(*args, **kwargs)

def unpool(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.unpool')(*args, **kwargs)

def temporal_shift(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.temporal_shift')(*args, **kwargs)

def shuffle_channel(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.vision_ops.shuffle_channel')(*args, **kwargs)

def frame(*args, **kwargs):
    return _bind('paddle_tpu_torch.signal.frame')(*args, **kwargs)

def overlap_add(*args, **kwargs):
    return _bind('paddle_tpu_torch.signal.overlap_add')(*args, **kwargs)

def stft(*args, **kwargs):
    return _bind('paddle_tpu_torch.signal.stft')(*args, **kwargs)

def accuracy_check(*args, **kwargs):
    return _bind('paddle_tpu_torch.ops.extra.accuracy_check')(*args, **kwargs)

__all__ = [
    'abs',
    'accuracy_check',
    'acos',
    'acosh',
    'adaptive_avg_pool1d',
    'adaptive_avg_pool2d',
    'adaptive_avg_pool3d',
    'adaptive_max_pool1d',
    'adaptive_max_pool2d',
    'adaptive_max_pool3d',
    'add',
    'add_',
    'addmm',
    'affine_grid',
    'all',
    'allclose',
    'alpha_dropout',
    'amax',
    'amin',
    'angle',
    'any',
    'arange',
    'arg_max',
    'arg_min',
    'argmax',
    'argmin',
    'argsort',
    'as_complex',
    'as_real',
    'as_strided',
    'asin',
    'asinh',
    'assign',
    'atan',
    'atan2',
    'atanh',
    'atleast_1d',
    'atleast_2d',
    'atleast_3d',
    'avg_pool1d',
    'avg_pool2d',
    'avg_pool3d',
    'batch_norm',
    'bce_loss',
    'bernoulli',
    'bernoulli_',
    'bicubic_interp',
    'bilinear',
    'bilinear_interp',
    'binary_cross_entropy',
    'binary_cross_entropy_with_logits',
    'bincount',
    'binomial',
    'bitwise_and',
    'bitwise_left_shift',
    'bitwise_not',
    'bitwise_or',
    'bitwise_right_shift',
    'bitwise_xor',
    'bmm',
    'broadcast_tensors',
    'broadcast_to',
    'bucketize',
    'cast',
    'cast_',
    'cdist',
    'ceil',
    'celu',
    'channel_shuffle',
    'cholesky',
    'cholesky_inverse',
    'cholesky_solve',
    'chunk',
    'clip',
    'clip_',
    'clip_by_norm',
    'clone',
    'complex',
    'concat',
    'concat_v2',
    'cond',
    'conj',
    'conv1d',
    'conv1d_transpose',
    'conv2d',
    'conv2d_transpose',
    'conv3d',
    'conv3d_transpose',
    'copysign',
    'corrcoef',
    'cos',
    'cosh',
    'cosine_embedding_loss',
    'cosine_similarity',
    'count_nonzero',
    'cov',
    'crop',
    'cross',
    'cross_entropy',
    'ctc_loss',
    'cummax',
    'cummin',
    'cumprod',
    'cumsum',
    'deg2rad',
    'det',
    'diag',
    'diag_embed',
    'diagflat',
    'diagonal',
    'dice_loss',
    'diff',
    'digamma',
    'dirichlet',
    'dist',
    'divide',
    'divide_',
    'dot',
    'dropout',
    'dropout2d',
    'dropout3d',
    'dstack',
    'edit_distance',
    'eig',
    'eigh',
    'eigvals',
    'eigvalsh',
    'einsum',
    'elementwise_add',
    'elementwise_div',
    'elementwise_floordiv',
    'elementwise_max',
    'elementwise_min',
    'elementwise_mod',
    'elementwise_mul',
    'elementwise_pow',
    'elementwise_sub',
    'elu',
    'elu_',
    'embedding',
    'empty',
    'empty_like',
    'equal',
    'equal_all',
    'erf',
    'erfinv',
    'exp',
    'exp_',
    'expand',
    'expand_as',
    'expm1',
    'eye',
    'fill',
    'fill_constant',
    'fill_diagonal',
    'flash_attn',
    'flatten',
    'flatten_',
    'flip',
    'floor',
    'floor_divide',
    'floor_mod',
    'fmax',
    'fmin',
    'fmod',
    'fold',
    'frac',
    'frame',
    'frobenius_norm',
    'full',
    'full_like',
    'fused_softmax_mask',
    'fused_softmax_mask_upper_triangle',
    'gammainc',
    'gammaincc',
    'gammaln',
    'gather',
    'gather_nd',
    'gather_tree',
    'gaussian',
    'gcd',
    'gelu',
    'glu',
    'greater_equal',
    'greater_than',
    'grid_sample',
    'group_norm',
    'gumbel_softmax',
    'hardshrink',
    'hardsigmoid',
    'hardswish',
    'hardtanh',
    'heaviside',
    'hinge_embedding_loss',
    'hinge_loss',
    'histogram',
    'histogramdd',
    'householder_product',
    'hstack',
    'huber_loss',
    'hypot',
    'i0',
    'i0e',
    'i1',
    'i1e',
    'imag',
    'increment',
    'index_add',
    'index_fill',
    'index_put',
    'index_sample',
    'index_select',
    'inner',
    'instance_norm',
    'interpolate',
    'inv',
    'inverse',
    'is_empty',
    'is_tensor',
    'isclose',
    'isfinite',
    'isinf',
    'isnan',
    'isneginf',
    'isposinf',
    'isreal',
    'kl_div',
    'kldiv_loss',
    'kron',
    'kthvalue',
    'l1_loss',
    'label_smooth',
    'laplace',
    'layer_norm',
    'lcm',
    'leaky_relu',
    'lerp',
    'less_equal',
    'less_than',
    'lgamma',
    'linear',
    'linear_interp',
    'linspace',
    'local_response_norm',
    'log',
    'log10',
    'log1p',
    'log2',
    'log_loss',
    'log_sigmoid',
    'log_softmax',
    'logaddexp',
    'logcumsumexp',
    'logical_and',
    'logical_not',
    'logical_or',
    'logical_xor',
    'logit',
    'logsigmoid',
    'logspace',
    'logsumexp',
    'lookup_table_v2',
    'lp_pool1d',
    'lp_pool2d',
    'lstsq',
    'lu',
    'lu_unpack',
    'margin_cross_entropy',
    'margin_ranking_loss',
    'masked_fill',
    'masked_fill_',
    'masked_scatter',
    'masked_select',
    'matmul',
    'matmul_v2',
    'matrix_norm',
    'matrix_power',
    'matrix_rank',
    'max',
    'max_pool1d',
    'max_pool2d',
    'max_pool2d_with_index',
    'max_pool3d',
    'maximum',
    'maxout',
    'mean',
    'median',
    'meshgrid',
    'min',
    'minimum',
    'mish',
    'mm',
    'mod',
    'mode',
    'moveaxis',
    'mse_loss',
    'multi_dot',
    'multi_label_soft_margin_loss',
    'multinomial',
    'multiplex',
    'multiply',
    'multiply_',
    'mv',
    'nan_to_num',
    'nanmean',
    'nanmedian',
    'nanquantile',
    'nansum',
    'nearest_interp',
    'neg',
    'nextafter',
    'nll_loss',
    'nonzero',
    'norm',
    'normal',
    'normal_',
    'normalize',
    'not_equal',
    'npair_loss',
    'numel',
    'one_hot',
    'one_hot_v2',
    'ones',
    'ones_like',
    'ormqr',
    'outer',
    'overlap_add',
    'p_norm',
    'pad',
    'pad3d',
    'pca_lowrank',
    'pinv',
    'pixel_shuffle',
    'pixel_unshuffle',
    'poisson',
    'polar',
    'polygamma',
    'pool2d',
    'pool3d',
    'pow',
    'prelu',
    'prod',
    'put_along_axis',
    'qr',
    'quantile',
    'rad2deg',
    'rand',
    'rand_like',
    'randint',
    'randint_like',
    'randn',
    'randn_like',
    'randperm',
    'range',
    'real',
    'reciprocal',
    'reduce_all',
    'reduce_any',
    'reduce_as',
    'reduce_max',
    'reduce_mean',
    'reduce_min',
    'reduce_prod',
    'reduce_sum',
    'relu',
    'relu6',
    'relu_',
    'remainder',
    'renorm',
    'repeat_interleave',
    'reshape',
    'reshape2',
    'reshape_',
    'reverse',
    'rms_norm',
    'roll',
    'rot90',
    'round',
    'rrelu',
    'rsqrt',
    'scale',
    'scale_',
    'scatter',
    'scatter_',
    'scatter_nd',
    'scatter_nd_add',
    'searchsorted',
    'segment_pool',
    'selu',
    'send_u_recv',
    'sequence_mask',
    'shape',
    'shard_index',
    'shuffle_channel',
    'sigmoid',
    'sigmoid_cross_entropy_with_logits',
    'sigmoid_focal_loss',
    'sign',
    'silu',
    'sin',
    'sinh',
    'slice',
    'slogdet',
    'smooth_l1_loss',
    'soft_margin_loss',
    'softmax',
    'softmax_',
    'softmax_with_cross_entropy',
    'softplus',
    'softshrink',
    'softsign',
    'solve',
    'sort',
    'split',
    'split_with_num',
    'sqrt',
    'sqrt_',
    'square',
    'square_error_cost',
    'squared_l2_norm',
    'squeeze',
    'squeeze2',
    'squeeze_',
    'stack',
    'standard_gamma',
    'standard_normal',
    'stanh',
    'std',
    'stft',
    'strided_slice',
    'subtract',
    'subtract_',
    'sum',
    'svd',
    'svd_lowrank',
    'swapaxes',
    'swiglu',
    'swish',
    't',
    'take',
    'take_along_axis',
    'tan',
    'tanh',
    'tanh_shrink',
    'tanhshrink',
    'temporal_shift',
    'tensor_split',
    'tensor_unfold',
    'tensordot',
    'thresholded_relu',
    'tile',
    'to_tensor',
    'top_k_v2',
    'top_p_sampling',
    'topk',
    'trace',
    'transpose',
    'transpose2',
    'triangular_solve',
    'tril',
    'tril_indices',
    'trilinear_interp',
    'triplet_margin_loss',
    'triu',
    'triu_indices',
    'trunc',
    'unbind',
    'unfold',
    'uniform',
    'uniform_',
    'unique',
    'unique_consecutive',
    'unpool',
    'unsqueeze',
    'unsqueeze2',
    'unsqueeze_',
    'unstack',
    'upsample',
    'var',
    'vector_norm',
    'view',
    'view_as',
    'view_dtype',
    'view_shape',
    'viterbi_decode',
    'vstack',
    'where',
    'where_',
    'zeros',
    'zeros_like',
]
