from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
