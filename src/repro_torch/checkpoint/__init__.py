from .session import (TrainSession, check_fingerprint,  # noqa: F401
                      latest_session_step, load_session, save_session,
                      session_fingerprint)
from .store import (CheckpointCorruptError, CheckpointStore,  # noqa: F401
                    complete_steps, latest_step, latest_valid_step, load,
                    restore, save, validate)
