"""The port's distributed runtime on one device: checkpoints, the
fault-tolerant training runner and straggler watchdog, the sharding
rules and elastic resharding."""
