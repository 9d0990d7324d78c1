"""The model zoo as ``torch.nn`` modules (``dense``, ``vlm`` and ``ssm``
families); attention and the selective scan run in the hand-written
kernels on the card."""

from repro_torch.models.api import Model, build_model  # noqa: F401
