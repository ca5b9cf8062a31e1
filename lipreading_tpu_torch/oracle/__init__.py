"""Constants and weight containers of the preprocessing models, copied from
``lipreading_tpu/oracle`` so that the port reads the same assets."""
