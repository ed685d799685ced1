#!/bin/bash
# Shared helpers for the staged experiment recipes (source this file:
#   . "$(dirname "$0")/lib.sh"
# ).  Stages are checkpoint-resumable, so a retry after a transient
# failure (watchdog exit 114 on a hung step, a preempted host) resumes from the last epoch boundary rather than restarting.
retry() {
  for i in 1 2 3; do
    "$@" && return 0
    echo "stage attempt $i failed (rc=$?), retrying in 90s" >&2
    sleep 90
  done
  return 1
}
