"""Host tools: BVH parsing and forward kinematics, BEAT joint conversion,
silence splitting, the utterance-set builder, transcription and
visualisation (``convofusion_tpu/scripts``)."""
