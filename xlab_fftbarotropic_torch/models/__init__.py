"""Model families ported so far: barotropic vorticity, passive tracer,
rotating shallow water."""
