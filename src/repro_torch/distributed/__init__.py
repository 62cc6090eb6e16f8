"""The port's distributed runtime: checkpoints, the fault-tolerant
training runner and straggler watchdog, the sharding rules with
placement over a process group's device mesh, and elastic resharding."""
