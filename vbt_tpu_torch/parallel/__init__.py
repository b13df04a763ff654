"""Work over several devices of one process: the ordered device list
(:mod:`.mesh`) and the tracker's chunk relay along a video's frame axis
(:mod:`.time_shard`)."""
