"""Training engines: state and checkpoints, optimizers, train steps, the
multi-engine orchestrator and the config-driven factory (port of
``tortoise_tts_tpu/engine/``)."""
