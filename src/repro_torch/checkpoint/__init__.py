"""Tree checkpointing (npz) + durable router state."""
from repro_torch.checkpoint.router_state import (RouterState,  # noqa: F401
                                                 load_router_state,
                                                 save_router_state)
from repro_torch.checkpoint.store import (CheckpointManager,  # noqa: F401
                                          load, save)
