"""RL surfaces of the port (action lowering for ``Session.step``)."""
