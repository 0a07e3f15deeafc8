from acmmp_tpu_torch.io.dmb import read_dmb, write_dmb  # noqa: F401
from acmmp_tpu_torch.io.ply import read_ply, write_ply  # noqa: F401
