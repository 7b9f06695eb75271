"""INFaaS core: the paper's contribution (model-less abstraction, variant
selection, two-level autoscaling, multi-tenant sharing)."""
from repro_torch.core.api import INFaaS                      # noqa: F401
from repro_torch.core.master import Master, MasterConfig     # noqa: F401
from repro_torch.core.metadata import MetadataStore          # noqa: F401
from repro_torch.core.repository import ModelRepository      # noqa: F401
from repro_torch.core.selection import VariantSelector       # noqa: F401
from repro_torch.core.worker import Query, Worker, WorkerConfig  # noqa: F401
