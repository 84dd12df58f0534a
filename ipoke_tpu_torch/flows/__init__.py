"""Invertible-flow engine (counterpart of ``ipoke_tpu/flows``)."""

from .base import (
    Chain,
    Flow,
    ParamTree,
    count_params,
    tree_flatten,
    tree_leaves,
    tree_map,
)
from .loss import flow_loss, nll
from .macow import (
    MaCowUnitChain,
    MaskedConvFlow,
    MultiScaleInternal,
    MultiScalePrior,
    MultiscaleStack,
    NICE2d,
    ScannedSteps,
    make_macow_step,
    make_macow_unit,
)
from .primitives import ActNorm, InvConvLU, Shuffle, SpaceToDepth


def build_macow_transformer(arch):
    """The multi-scale MaCow cINN from an ``architecture`` config block with
    the reference's key names (flow_in_channels, flow_mid_channels or
    flow_mid_channels_factor, h_channels, factor, num_steps, kernel_size,
    transform, prior_transform, activation, use1x1, condition_nice), or
    with ``multistack`` a ``MultiscaleStack`` (levels, factors, reshape)."""
    get = arch.get
    in_c = get("flow_in_channels")
    mid = get("flow_mid_channels")
    if mid is None:
        mid = int(get("flow_mid_channels_factor", 8) * in_c)
    if get("multistack", False):
        return MultiscaleStack(
            levels=tuple(tuple(l) for l in get("levels")),
            factors=tuple(get("factors")),
            in_channels=in_c,
            mid_channels_factor=int(get("flow_mid_channels_factor", 8)),
            h_channels=int(get("h_channels", 0)),
            reshape=get("reshape", "none"),
            transform=get("transform", "affine"),
            prior_transform=get("prior_transform", "affine"),
            kernel_size=tuple(get("kernel_size", (2, 3))),
            activation=get("activation", "elu"),
            use_1x1=bool(get("use1x1", False)),
            condition_nice=bool(get("condition_nice", False)),
        )
    return MultiScaleInternal(
        num_steps=tuple(get("num_steps")),
        in_channels=in_c,
        hidden_channels=mid,
        h_channels=int(get("h_channels", 0)),
        factor=int(get("factor", 16)),
        transform=get("transform", "affine"),
        prior_transform=get("prior_transform", "affine"),
        kernel_size=tuple(get("kernel_size", (2, 3))),
        activation=get("activation", "elu"),
        use_1x1=bool(get("use1x1", False)),
        condition_nice=bool(get("condition_nice", False)),
    )
