"""Training-side fault tolerance: straggler detection, preemption, step
timing (`train.ft`), which the fleet scheduler's stall detection reuses."""
